"""Bit-Bots ``.mcap`` rosbag import strategy (counterpart of
``soccerdiffusion_tpu/ingest/bitbots.py``).

Counterpart of reference dataset/imports/strategies/bit_bots.py:21-190, with
one structural change for testability: the conversion core consumes an
abstract stream of ``(topic, publish_time_ns, ros_msg)`` tuples plus a
``RecordingInfo``, so unit tests feed synthesized SimpleNamespace messages
(like the reference's own test fixtures) and the mcap reading lives in a
thin adapter gated on the ``mcap``/``mcap_ros2`` packages.

Behavioral details preserved:
  * 7 consumed topics (USED_TOPICS)
  * IMU fallback: without /imu/data, the orientation is the INVERTED
    base_link->base_footprint /tf quaternion (bit_bots.py:86-96)
  * conversion only starts once every synced modality has been seen; the
    first complete sample defines relative time zero (bit_bots.py:100-107)
  * head joint states are copied over the head joint commands as an
    interpolation workaround (bit_bots.py:127-130)
  * recording timeframe from the summary chunk indexes (bit_bots.py:159-172)
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Iterable, Iterator

from soccerdiffusion_tpu_torch.ingest.converters import (
    BitBotsGameStateConverter,
    BitbotsImageConverter,
    Converter,
    SyncedDataConverter,
)
from soccerdiffusion_tpu_torch.ingest.importer import ImportStrategy
from soccerdiffusion_tpu_torch.ingest.rows import (
    ImportMetadata,
    InputData,
    ModelData,
    Quaternion,
    RecordingRow,
)

logger = logging.getLogger("soccerdiffusion_tpu_torch")

USED_TOPICS = [
    "/DynamixelController/command",
    "/camera/image_proc",
    "/camera/image_to_record",
    "/gamestate",
    "/imu/data",
    "/joint_states",
    "/tf",
]


@dataclass
class RecordingInfo:
    start_time_ns: int
    end_time_ns: int
    has_imu_data: bool
    available_topics: list[str]


def _quat_inverse(w: float, x: float, y: float, z: float) -> tuple[float, float, float, float]:
    """Quaternion inverse (conjugate / norm^2), wxyz in, wxyz out."""
    n = w * w + x * x + y * y + z * z
    return w / n, -x / n, -y / n, -z / n


class BitBotsImportStrategy(ImportStrategy):
    def __init__(
        self,
        metadata: ImportMetadata,
        image_converter: BitbotsImageConverter,
        game_state_converter: BitBotsGameStateConverter,
        synced_data_converter: SyncedDataConverter,
    ):
        self.metadata = metadata
        self.image_converter = image_converter
        self.game_state_converter = game_state_converter
        self.synced_data_converter = synced_data_converter
        self.model_data = ModelData()

    # -------------------------------------------------------- file adapter

    def convert_to_model_data(self, file_path: Path) -> ModelData:
        info, stream = read_mcap(Path(file_path))
        return self.convert_stream(info, stream, original_file=Path(file_path).name)

    def stream_model_data(self, file_path: Path,
                          flush_rows: int = 50_000) -> Iterator[ModelData]:
        """Bounded-memory protocol (ImportStrategy.stream_model_data): the
        mcap message iterator is consumed lazily and rows are handed off
        every ~``flush_rows``."""
        info, stream = read_mcap(Path(file_path))
        yield from self.convert_stream_chunks(
            info, stream, Path(file_path).name, flush_rows)

    # ------------------------------------------------------ conversion core

    def convert_stream(
        self,
        info: RecordingInfo,
        messages: Iterable[tuple[str, int, Any]],
        original_file: str = "<stream>",
    ) -> ModelData:
        """All-at-once conversion (reference semantics): merge every chunk."""
        out = ModelData()
        for delta in self.convert_stream_chunks(info, messages, original_file,
                                                flush_rows=0):
            out.recording = out.recording or delta.recording
            out.merge(delta)
        self.model_data = out
        return out

    def _pending_rows(self) -> int:
        d = self.model_data
        return (len(d.joint_states) + len(d.joint_commands) + len(d.rotations)
                + len(d.images) + len(d.game_states))

    def _take_delta(self) -> ModelData:
        """Hand off accumulated rows, keeping the (shared) recording row."""
        delta = self.model_data
        self.model_data = ModelData(recording=delta.recording)
        return delta

    def convert_stream_chunks(
        self,
        info: RecordingInfo,
        messages: Iterable[tuple[str, int, Any]],
        original_file: str = "<stream>",
        flush_rows: int = 50_000,
    ) -> Iterator[ModelData]:
        """Bounded-memory conversion: yield a ``ModelData`` delta every time
        ~``flush_rows`` rows have accumulated (0 = only one final delta).
        Every delta shares the same ``recording`` object, whose metadata
        (image scaling etc.) keeps being populated as conversion proceeds —
        consumers should re-read it after exhaustion (SURVEY.md §2.9
        streaming extraction hot path; the reference materializes the whole
        bag in RAM, model_importer.py:27-41)."""
        self.model_data = ModelData()
        self.model_data.recording = self._create_recording(info, original_file)
        first_used_msg_time: int | None = None
        latest = InputData()

        for topic, publish_time_ns, msg in messages:
            converter: Converter | None = None
            match topic:
                case "/gamestate":
                    latest.game_state = msg
                    converter = self.game_state_converter
                case "/camera/image_proc" | "/camera/image_to_record":
                    latest.image = msg
                    converter = self.image_converter
                case "/joint_states":
                    latest.set_joint_state_msg(msg)
                    converter = self.synced_data_converter
                case "/DynamixelController/command":
                    latest.set_joint_command_msg(msg)
                    converter = self.synced_data_converter
                case "/imu/data":
                    assert info.has_imu_data, "IMU data not expected in this recording"
                    o = msg.orientation
                    latest.rotation = Quaternion(x=o.x, y=o.y, z=o.z, w=o.w)
                    converter = self.synced_data_converter
                case "/tf":
                    if not info.has_imu_data:
                        for tf_msg in msg.transforms:
                            if (
                                tf_msg.child_frame_id == "base_footprint"
                                and tf_msg.header.frame_id == "base_link"
                            ):
                                q = tf_msg.transform.rotation
                                w, x, y, z = _quat_inverse(q.w, q.x, q.y, q.z)
                                latest.rotation = Quaternion(x=x, y=y, z=z, w=w)
                                converter = self.synced_data_converter
                case _:
                    logger.warning(f"unhandled topic {topic}; skipping")

            if self._is_all_synced_data_available(latest):
                if first_used_msg_time is None:
                    first_used_msg_time = publish_time_ns
                    self._initial_conversion(latest)
                elif converter is not None:
                    rel_ts = (publish_time_ns - first_used_msg_time) / 1e9
                    self._create_models(converter, latest, rel_ts)

            if flush_rows and self._pending_rows() >= flush_rows:
                yield self._take_delta()

        yield self._take_delta()

    def _initial_conversion(self, data: InputData) -> None:
        assert self._is_all_synced_data_available(data)
        if data.game_state is not None:
            self._create_models(self.game_state_converter, data, 0.0)
        self._create_models(self.synced_data_converter, data, 0.0)

    def _create_models(self, converter: Converter, data: InputData, rel_ts: float) -> None:
        assert self.model_data.recording is not None
        converter.populate_recording_metadata(data, self.model_data.recording)
        model_data = converter.convert_to_model(data, rel_ts, self.model_data.recording)
        # Head commands get no interpolation upstream; copy the measured head
        # joint state over them (reference bit_bots.py:127-130).
        for command, state in zip(model_data.joint_commands, model_data.joint_states):
            command.joints["head_pan"] = state.joints["head_pan"]
            command.joints["head_tilt"] = state.joints["head_tilt"]
        self.model_data.merge(model_data)

    @staticmethod
    def _is_all_synced_data_available(data: InputData) -> bool:
        commands_ready = all(c is not None for c in data.joint_command.values())
        return commands_ready and data.joint_state is not None and data.rotation is not None

    def _create_recording(self, info: RecordingInfo, original_file: str) -> RecordingRow:
        return RecordingRow(
            allow_public=self.metadata.allow_public,
            original_file=original_file,
            team_name=self.metadata.team_name,
            robot_type=self.metadata.robot_type,
            start_time=datetime.fromtimestamp(info.start_time_ns / 1e9),
            end_time=datetime.fromtimestamp(info.end_time_ns / 1e9),
            location=self.metadata.location,
            simulated=self.metadata.simulated,
            img_width_scaling=0.0,  # set while processing images
            img_height_scaling=0.0,
        )


def read_mcap(path: Path) -> tuple[RecordingInfo, Iterator[tuple[str, int, Any]]]:
    """mcap adapter: the upstream ``mcap`` + ``mcap_ros2`` packages when
    installed, else the vendored reader + schema-driven CDR decoder
    (ingest/mcap_io.py)."""
    try:
        from mcap.reader import make_reader
        from mcap_ros2.decoder import DecoderFactory
    except ImportError:
        return _read_mcap_vendored(path)

    f = open(path, "rb")
    reader = make_reader(f, decoder_factories=[DecoderFactory()])
    summary = reader.get_summary()
    if summary is None:
        raise ValueError(f"no summary found in mcap file {path}")

    start = min(ci.message_start_time for ci in summary.chunk_indexes)
    end = max(ci.message_end_time for ci in summary.chunk_indexes)
    topics = [c.topic for c in summary.channels.values()]
    info = RecordingInfo(
        start_time_ns=start,
        end_time_ns=end,
        has_imu_data="/imu/data" in topics,
        available_topics=topics,
    )

    def stream() -> Iterator[tuple[str, int, Any]]:
        try:
            for _, channel, message, ros_msg in reader.iter_decoded_messages(topics=USED_TOPICS):
                yield channel.topic, message.publish_time, ros_msg
        finally:
            f.close()

    return info, stream()


def _read_mcap_vendored(path: Path) -> tuple[RecordingInfo, Iterator[tuple[str, int, Any]]]:
    """Standalone mcap path: vendored container reader + CDR decoder, message
    layouts parsed from the schema text embedded in the bag itself."""
    from soccerdiffusion_tpu_torch.ingest.mcap_io import McapReader, decode_cdr

    reader = McapReader.from_file(path)
    start, end = reader.message_time_range
    topics = [c.topic for c in reader.channels.values()]
    info = RecordingInfo(
        start_time_ns=start,
        end_time_ns=end,
        has_imu_data="/imu/data" in topics,
        available_topics=topics,
    )

    def stream() -> Iterator[tuple[str, int, Any]]:
        for channel, schema, message in reader.iter_messages(topics=USED_TOPICS):
            assert schema is not None, f"channel {channel.topic} has no schema"
            assert schema.encoding == "ros2msg", (
                f"vendored decoder handles ros2msg schemas, got {schema.encoding!r}"
            )
            msg = decode_cdr(schema.data.decode(), schema.name, message.data)
            yield channel.topic, message.publish_time, msg

    return info, stream()
