"""Direct mcap -> packed training shards, bounded memory, no SQLite hop.

SURVEY.md §2.9's replacement plan calls for a streaming extraction hot path
(the reference routes everything through SQLAlchemy + SQLite even when the
only consumer is training; model_importer.py:27-41). This module consumes an
import strategy's streaming protocol (``stream_model_data`` deltas) and
appends rows straight into ``PackedDataset``-format shards on disk:

  * proprioceptive rows (commands / states / rotations) append to raw
    binary files that become .npy shards at finalize (header + O(1)-memory
    byte copy), so peak RSS is O(flush interval);
  * images resize once to the training resolution and append as uint8;
  * game states forward-fill onto the row grid at finalize (their row
    count is tiny); ``sampling_rate`` must be the rate the rows were
    RESAMPLED at (the CLI passes the 50 Hz default import rate — note the
    reference's own dataset layer assumes a 100 Hz stamp grid,
    pytorch.py:63/:314, which only matches its dummy data);
  * the result loads with ``PackedDataset.load`` and feeds the C++
    framepack assembler directly.

One command: ``python -m soccerdiffusion_tpu_torch.cli pack bit-bots <file.mcap>
<location> <out_dir>``. The counterpart of ``soccerdiffusion_tpu/ingest/
streaming.py``; frames of another size than the config's resolution go
through the port's numpy INTER_AREA (``data/resize.py``) where the JAX
package calls cv2.
"""

from __future__ import annotations

import logging
import json
import shutil
from pathlib import Path

import numpy as np

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data.dataset import np_quats_to_5d
from soccerdiffusion_tpu_torch.data.resize import resize_area
from soccerdiffusion_tpu_torch.data.schema import RobotState
from soccerdiffusion_tpu_torch.ingest.importer import ImportStrategy
from soccerdiffusion_tpu_torch.ingest.rows import camelcase_to_snakecase

logger = logging.getLogger("soccerdiffusion_tpu_torch")


class NpyAppender:
    """Append rows to a raw binary file; finalize writes a real .npy
    (header for the now-known shape + streamed byte copy)."""

    def __init__(self, path: Path, dtype, row_shape: tuple[int, ...]):
        self.path = Path(path)
        self.tmp = self.path.with_suffix(".bin")
        self.dtype = np.dtype(dtype)
        self.row_shape = tuple(int(s) for s in row_shape)
        self.count = 0
        self._fh = open(self.tmp, "wb")

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=self.dtype)
        assert rows.shape[1:] == self.row_shape, (rows.shape, self.row_shape)
        self._fh.write(rows.tobytes())
        self.count += rows.shape[0]

    def finalize(self) -> None:
        self._fh.close()
        shape = (self.count, *self.row_shape)
        with open(self.path, "wb") as out:
            np.lib.format.write_array_header_2_0(
                out, {"descr": np.lib.format.dtype_to_descr(self.dtype),
                      "fortran_order": False, "shape": shape})
            with open(self.tmp, "rb") as src:
                shutil.copyfileobj(src, out, length=16 * 1024 * 1024)
        self.tmp.unlink()


def _joints_matrix(rows, joint_order_snake) -> np.ndarray:
    return np.asarray(
        [[row.joints[j] for j in joint_order_snake] for row in rows],
        dtype=np.float32,
    )


def pack_from_stream(strategy: ImportStrategy, file_path: str | Path,
                     config: ModelConfig, out_dir: str | Path,
                     flush_rows: int = 50_000,
                     trajectory_stride: int = 1,
                     sampling_rate: int = 100,
                     max_fps_video: int = 10) -> dict:
    """Stream one recording through ``strategy`` into packed shards at
    ``out_dir``. Returns row-count stats. Peak memory is O(flush_rows)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    J = config.num_joints
    rot_dim = config.imu_input_dim
    five_dim = config.imu_orientation_embedding_method == "five_dim"
    res = config.image_resolution
    joint_order = [camelcase_to_snakecase(n) for n in config.joint_names]
    state_to_int = {s: i for i, s in enumerate(RobotState.values())}

    cmds = NpyAppender(out / "joint_commands.npy", np.float32, (J,))
    states = NpyAppender(out / "joint_states.npy", np.float32, (J,))
    rots = NpyAppender(out / "rotations.npy", np.float32, (rot_dim,))
    images = (NpyAppender(out / "images.npy", np.uint8, (res, res, 3))
              if config.use_images else None)
    img_stamps: list[float] = []
    gs_stamps: list[float] = []
    gs_vals: list[int] = []

    for delta in strategy.stream_model_data(Path(file_path), flush_rows):
        if delta.joint_commands:
            cmds.append(_joints_matrix(delta.joint_commands, joint_order))
        if delta.joint_states:
            states.append(_joints_matrix(delta.joint_states, joint_order))
        if delta.rotations:
            quats = np.asarray([[r.x, r.y, r.z, r.w] for r in delta.rotations],
                               dtype=np.float32)
            rots.append(np_quats_to_5d(quats) if five_dim else quats)
        for g in delta.game_states:
            gs_stamps.append(float(g.stamp))
            gs_vals.append(state_to_int.get(g.state, int(RobotState.UNKNOWN)))
        if images is not None:
            for im in delta.images:
                frame = im.image
                frame = resize_area(frame, res, res)
                images.append(frame[None])
                img_stamps.append(float(im.stamp))

    n_rows = cmds.count
    if not (n_rows and states.count == n_rows and rots.count == n_rows):
        raise ValueError(
            f"inconsistent row counts: {cmds.count} commands, "
            f"{states.count} states, {rots.count} rotations")

    # Forward-fill game state onto the row grid (counts are tiny).
    if gs_vals:
        stamps_grid = np.arange(n_rows) / sampling_rate
        gs_stamp_arr = np.asarray(gs_stamps, dtype=np.float32)
        gs_val_arr = np.asarray(gs_vals, dtype=np.int32)
        order = np.argsort(gs_stamp_arr, kind="stable")
        gs_stamp_arr, gs_val_arr = gs_stamp_arr[order], gs_val_arr[order]
        pos = np.searchsorted(gs_stamp_arr, stamps_grid, side="right") - 1
        filled = np.where(pos >= 0, gs_val_arr[np.maximum(pos, 0)],
                          int(RobotState.UNKNOWN)).astype(np.int32)
    else:
        # a bag with no /gamestate messages is importable; every row UNKNOWN
        filled = np.full(n_rows, int(RobotState.UNKNOWN), dtype=np.int32)

    cmds.finalize()
    states.finalize()
    rots.finalize()
    np.save(out / "game_states.npy", filled)
    has_images = images is not None
    if has_images:
        images.finalize()
        np.save(out / "image_stamps.npy",
                np.asarray(img_stamps, dtype=np.float32))
    (out / "index.json").write_text(json.dumps({
        "rec_row_starts": [0],
        "rec_lengths": [n_rows],
        "num_joints": J,
        "rot_dim": rot_dim,
        "trajectory_stride": trajectory_stride,
        "sampling_rate": sampling_rate,
        "max_fps_video": max_fps_video,
        "img_rec_starts": [0] if has_images else None,
        "img_rec_counts": [images.count] if has_images else None,
    }))
    stats = {
        "rows": int(n_rows),
        "images": int(images.count) if has_images else 0,
        "game_states": int(len(gs_vals)),
        "out_dir": str(out),
    }
    logger.info(f"packed shards: {stats}")
    return stats
