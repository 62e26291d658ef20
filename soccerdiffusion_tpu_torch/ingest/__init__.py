"""Ingest pipeline: recordings -> the SQLite dataset (counterpart of
``soccerdiffusion_tpu/ingest/``, with the same public names).

Host-side Python (no JAX): streaming resampler state machines, converters
(synced modalities, images, game state), and import strategies for Bit-Bots
``.mcap`` rosbags (gated on the ``mcap`` package) and B-Human ``.log`` files
(gated on ``pybh``). Strategies consume abstract (topic, timestamp, message)
streams, so the conversion logic is unit-testable without ROS or the native
readers — the reference's own CI takes the same approach with fake messages
(reference tests/dataset/conftest.py:6-65).

Host-side Python (numpy, sqlite3) without cv2: frames are resized by
``data/resize.py`` and their channels reordered by slicing.
"""

from soccerdiffusion_tpu_torch.ingest.rows import (
    ImageRow,
    ImportMetadata,
    InputData,
    JointsRow,
    ModelData,
    RecordingRow,
    RotationRow,
    GameStateRow,
    joints_dict_from_msg_data,
)
from soccerdiffusion_tpu_torch.ingest.resampling import (
    MaxRateResampler,
    OriginalRateResampler,
    PreviousInterpolationResampler,
    Resampler,
    Sample,
)
from soccerdiffusion_tpu_torch.ingest.converters import (
    BHumanGameStateConverter,
    BHumanImageConverter,
    BitBotsGameStateConverter,
    BitbotsImageConverter,
    Converter,
    SyncedDataConverter,
)
from soccerdiffusion_tpu_torch.ingest.importer import ImportStrategy, ModelImporter

__all__ = [
    "ImportMetadata",
    "InputData",
    "ModelData",
    "RecordingRow",
    "ImageRow",
    "RotationRow",
    "JointsRow",
    "GameStateRow",
    "joints_dict_from_msg_data",
    "Sample",
    "Resampler",
    "PreviousInterpolationResampler",
    "MaxRateResampler",
    "OriginalRateResampler",
    "Converter",
    "SyncedDataConverter",
    "BitbotsImageConverter",
    "BHumanImageConverter",
    "BitBotsGameStateConverter",
    "BHumanGameStateConverter",
    "ImportStrategy",
    "ModelImporter",
]
