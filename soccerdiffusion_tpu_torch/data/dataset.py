"""Windowed training dataset over recording arrays (counterpart of
``soccerdiffusion_tpu/data/dataset.py``).

Each recording's time series are held as contiguous numpy arrays and
windows are gathered by slicing, with the JAX package's (and the
reference's) padding semantics:

  * history windows are left-padded with zeros;
  * IMU windows are left-padded with the identity quaternion;
  * image windows keep the last <= F frames within (stamp - (F + 1) /
    max_fps_video, stamp], right-aligned, resized to ``image_resolution``
    with INTER_AREA (``data/resize.py``), normalised with the ImageNet
    statistics, left-padded with zero images stamped at the context start;
  * the game state is the last state at or before the stamp, UNKNOWN if none.

Index space: per recording (n_commands - future_len) / stride windows,
concatenated. Given the same seed, ``batches``, ``sample_targets``,
``image_boundary_indices`` and ``oversampled_order`` give the same arrays as
the JAX package. ``from_sqlite`` reads every recording of a reference-schema
database (``data/schema.py``) with the JAX package's queries; its frames
stay in the database and are fetched per window (``SqliteImageStore``), or
are decoded up front with ``stream_images=False``.
"""

from __future__ import annotations

import bisect
import sqlite3
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data.resize import resize_area
from soccerdiffusion_tpu_torch.data.schema import RobotState, connect

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
IDENTITY_QUAT = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def np_quats_to_5d(quats_xyzw: np.ndarray) -> np.ndarray:
    """xyzw quaternions -> [axis (3), sin(angle), cos(angle)]."""
    q = quats_xyzw.astype(np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    xyz, w = q[..., :3], q[..., 3]
    len_xyz = np.linalg.norm(xyz, axis=-1)
    axis = xyz / np.maximum(len_xyz, 1e-12)[..., None]
    default_axis = np.zeros_like(axis)
    default_axis[..., 0] = 1.0
    axis = np.where((len_xyz < 1e-6)[..., None], default_axis, axis)
    angle = np.where(len_xyz < 1e-6, 0.0, 2.0 * np.arctan2(len_xyz, w))
    return np.concatenate([axis, np.sin(angle)[..., None], np.cos(angle)[..., None]],
                          axis=-1).astype(np.float32)


def preprocess_image(raw_rgb8: np.ndarray, resolution: int) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> float32 (resolution, resolution, 3): resized
    with INTER_AREA where its size differs, scaled to [0, 1], normalised
    with the ImageNet statistics."""
    img = resize_area(raw_rgb8, resolution, resolution)
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class SqliteImageStore:
    """Frames read from the database one at a time: ``store[k]`` is the k-th
    frame's uint8 (H, W, 3) blob, only rowids are kept in memory, so a
    recording larger than RAM trains. ``fetch_count`` counts the reads."""

    def __init__(self, conn: sqlite3.Connection, rowids: np.ndarray, height: int, width: int):
        self._conn = conn
        self._rowids = np.asarray(rowids, dtype=np.int64)
        self._hw = (height, width)
        self.fetch_count = 0

    def __len__(self) -> int:
        return len(self._rowids)

    def __getitem__(self, k: int) -> np.ndarray:
        row = self._conn.execute("SELECT data FROM Image WHERE _id=?",
                                 (int(self._rowids[k]),)).fetchone()
        self.fetch_count += 1
        return np.frombuffer(row[0], dtype=np.uint8).reshape(*self._hw, 3)


@dataclass
class RecordingArrays:
    """One recording's synchronized time series, in canonical joint order."""

    joint_commands: np.ndarray  # (n, J)
    joint_states: np.ndarray  # (n, J)
    rotations: np.ndarray  # (n, 4) xyzw
    game_states: np.ndarray  # (m,) int32, sorted by stamp
    game_state_stamps: np.ndarray  # (m,) float32
    image_stamps: np.ndarray | None = None  # (k,) float32, sorted
    images: np.ndarray | SqliteImageStore | None = None  # (k, H, W, 3) uint8, or read lazily
    # the "vision" dummy task's cue latent per frame (data/dummy.py)
    vision_u: np.ndarray | None = None


class WindowedDataset:
    def __init__(self, recordings: list[RecordingArrays], config: ModelConfig,
                 trajectory_stride: int = 1, sampling_rate: int = 100, max_fps_video: int = 10):
        if not recordings:
            raise ValueError("no recordings")
        self.recordings = recordings
        self.cfg = config
        self.stride = trajectory_stride
        self.sampling_rate = sampling_rate
        self.max_fps_video = max_fps_video
        future = config.trajectory_prediction_length
        self.sample_boundaries: list[tuple[int, int, int]] = []
        total = 0
        for ri, rec in enumerate(recordings):
            count = int((len(rec.joint_commands) - future) / trajectory_stride)
            if count <= 0:
                continue
            self.sample_boundaries.append((total, total + count, ri))
            total += count
        self.num_samples = total
        self._starts = [b[0] for b in self.sample_boundaries]

    @classmethod
    def from_sqlite(cls, db_path: str | Path | sqlite3.Connection, config: ModelConfig,
                    trajectory_stride: int = 1, sampling_rate: int = 100, max_fps_video: int = 10,
                    decode_images: bool | None = None,
                    stream_images: bool = True) -> "WindowedDataset":
        """Every recording of a reference-schema SQLite database (a path is
        opened read-only), in ``_id`` order, its series ordered by stamp;
        the config's joint columns. With ``decode_images`` (default: the
        config's ``use_images``) the frames come too: with ``stream_images``
        read from the database per window (``SqliteImageStore``), else all
        decoded up front."""
        conn = db_path if isinstance(db_path, sqlite3.Connection) else connect(db_path, read_only=True)
        decode_images = config.use_images if decode_images is None else decode_images
        joint_cols = ", ".join(f'"{n}"' for n in config.joint_names)
        cur = conn.cursor()
        state_to_int = {s: i for i, s in enumerate(RobotState.values())}

        def series(query: str, rid: int) -> np.ndarray:
            return np.asarray(cur.execute(query, (rid,)).fetchall(), dtype=np.float32)

        recordings = []
        for (rid,) in cur.execute("SELECT _id FROM Recording ORDER BY _id").fetchall():
            cmds = series(f"SELECT {joint_cols} FROM JointCommands WHERE recording_id=? "
                          "ORDER BY stamp ASC", rid)
            if cmds.size == 0:
                continue
            states = series(f"SELECT {joint_cols} FROM JointStates WHERE recording_id=? "
                            "ORDER BY stamp ASC", rid)
            rots = series("SELECT x, y, z, w FROM Rotation WHERE recording_id=? ORDER BY stamp ASC",
                          rid)
            gs_rows = cur.execute("SELECT stamp, state FROM GameState WHERE recording_id=? "
                                  "ORDER BY stamp ASC", (rid,)).fetchall()
            gs_stamps = np.asarray([r[0] for r in gs_rows], dtype=np.float32)
            gs_vals = np.asarray([state_to_int.get(r[1], int(RobotState.UNKNOWN)) for r in gs_rows],
                                 dtype=np.int32)
            img_stamps, images = np.zeros((0,), dtype=np.float32), None
            if decode_images:
                img_index = cur.execute("SELECT _id, stamp FROM Image WHERE recording_id=? "
                                        "ORDER BY stamp ASC", (rid,)).fetchall()
                if img_index:
                    img_stamps = np.asarray([r[1] for r in img_index], dtype=np.float32)
                    rowids = np.asarray([r[0] for r in img_index], dtype=np.int64)
                    w, h = cur.execute("SELECT img_width, img_height FROM Recording WHERE _id=?",
                                       (rid,)).fetchone()
                    images = SqliteImageStore(conn, rowids, int(h), int(w))
                    if not stream_images:
                        images = np.stack([images[k] for k in range(len(rowids))])
            recordings.append(RecordingArrays(
                joint_commands=cmds, joint_states=states, rotations=rots, game_states=gs_vals,
                game_state_stamps=gs_stamps, image_stamps=img_stamps, images=images))
        return cls(recordings, config, trajectory_stride, sampling_rate, max_fps_video)

    @classmethod
    def from_dummy(cls, dummy_recordings, config: ModelConfig, **kwargs) -> "WindowedDataset":
        """Wrap ``generate_dummy_arrays`` output. The source recordings stay
        on ``.dummy_recordings``: the "vision" task's carry the cue latents
        (``vision_u`` / ``vision_dirs``) that the Bayes-oracle calibration
        reads (``evaluation/oracle.py``)."""
        recs = [RecordingArrays(
            joint_commands=d.joint_commands[:, : config.num_joints],
            joint_states=d.joint_states[:, : config.num_joints],
            rotations=d.rotations,
            game_states=d.game_states,
            game_state_stamps=(np.arange(len(d.game_states)) / 100).astype(np.float32),
            image_stamps=d.image_stamps, images=d.images, vision_u=d.vision_u)
            for d in dummy_recordings]
        dataset = cls(recs, config, **kwargs)
        dataset.dummy_recordings = list(dummy_recordings)
        return dataset

    def __len__(self) -> int:
        return self.num_samples

    @staticmethod
    def _pad_history(arr: np.ndarray, end: int, length: int, pad_row: np.ndarray) -> np.ndarray:
        window = arr[max(0, end - length):end]
        if len(window) < length:
            window = np.concatenate([np.tile(pad_row, (length - len(window), 1)), window], axis=0)
        return window.astype(np.float32)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if not 0 <= idx < self.num_samples:
            raise IndexError(idx)
        start_sample, _, ri = self.sample_boundaries[bisect.bisect_right(self._starts, idx) - 1]
        rec, cfg = self.recordings[ri], self.cfg
        cmd_idx = (idx - start_sample) * self.stride
        stamp = cmd_idx / self.sampling_rate
        out = {"joint_command": rec.joint_commands[
            cmd_idx: cmd_idx + cfg.trajectory_prediction_length].astype(np.float32)}
        zero_row = np.zeros((1, cfg.num_joints), dtype=np.float32)
        if cfg.use_action_history:
            out["joint_command_history"] = self._pad_history(
                rec.joint_commands, cmd_idx, cfg.action_context_length, zero_row)
        if cfg.use_joint_states:
            out["joint_state"] = self._pad_history(
                rec.joint_states, cmd_idx, cfg.joint_state_context_length, zero_row)
        if cfg.use_imu:
            quats = self._pad_history(rec.rotations, cmd_idx, cfg.imu_context_length,
                                      IDENTITY_QUAT[None])
            out["rotation"] = (np_quats_to_5d(quats)
                               if cfg.imu_orientation_embedding_method == "five_dim" else quats)
        if cfg.use_images:
            out["image_data"], out["image_stamps"] = self._image_window(rec, stamp)
            if rec.vision_u is not None:
                # the latent of the newest visible frame (the window's visibility rule)
                hi = np.searchsorted(rec.image_stamps, stamp, side="right")
                out["vision_u"] = np.float32(rec.vision_u[hi - 1] if hi > 0 else 0.0)
                out["vision_u_valid"] = np.float32(1.0 if hi > 0 else 0.0)
        if cfg.use_gamestate:
            gi = np.searchsorted(rec.game_state_stamps, stamp, side="right") - 1
            out["game_state"] = np.int32(rec.game_states[gi] if gi >= 0 else int(RobotState.UNKNOWN))
        return out

    def _image_window(self, rec: RecordingArrays, stamp: float) -> tuple[np.ndarray, np.ndarray]:
        """The last <= F frames within (stamp - (F + 1) / max_fps_video,
        stamp], normalised, right-aligned; zero frames before them, stamped
        at the context start."""
        num_frames, res = self.cfg.image_context_length, self.cfg.image_resolution
        context_len = (num_frames + 1) / self.max_fps_video
        frames = np.zeros((num_frames, res, res, 3), dtype=np.float32)
        stamps = np.full((num_frames,), stamp - context_len, dtype=np.float32)
        if rec.images is None or rec.image_stamps is None:
            return frames, stamps
        lo = np.searchsorted(rec.image_stamps, stamp - context_len, side="left")
        hi = np.searchsorted(rec.image_stamps, stamp, side="right")
        sel = np.arange(lo, hi)[-num_frames:]
        for j, k in enumerate(sel):
            frames[num_frames - len(sel) + j] = preprocess_image(rec.images[k], res)
        stamps[num_frames - len(sel):] = rec.image_stamps[sel]
        return frames, stamps

    @staticmethod
    def oversampled_order(n: int, special: np.ndarray, frac: float,
                          rng: np.random.Generator) -> np.ndarray:
        """An epoch's window order: a uniform permutation with ``frac`` of
        its slots re-drawn (with replacement) from ``special``."""
        order = rng.permutation(n)
        if frac <= 0.0 or len(special) == 0:
            return order
        k = int(round(frac * n))
        slots = rng.choice(n, size=k, replace=False)
        order[slots] = rng.choice(special, size=k, replace=True)
        return order

    def image_boundary_indices(self) -> np.ndarray:
        """Window indices whose stamp coincides with an image stamp: the
        windows where a camera frame has just become visible."""
        out = []
        if not self.cfg.use_images:
            return np.asarray(out, dtype=np.int64)
        half_tick = 0.5 / self.sampling_rate
        for start_sample, end_sample, ri in self.sample_boundaries:
            rec = self.recordings[ri]
            if rec.images is None or rec.image_stamps is None or not len(rec.image_stamps):
                continue
            for idx in range(start_sample, end_sample):
                stamp = (idx - start_sample) * self.stride / self.sampling_rate
                k = np.searchsorted(rec.image_stamps, stamp + half_tick) - 1
                if k >= 0 and abs(float(rec.image_stamps[k]) - stamp) < half_tick:
                    out.append(idx)
        return np.asarray(out, dtype=np.int64)

    def sample_targets(self, num_samples: int, seed: int = 0) -> np.ndarray:
        """Random target chunks stacked along time, for ``Normalizer.fit``
        (each window's ``joint_command``, without assembling the rest)."""
        idx = np.random.default_rng(seed).integers(0, len(self), size=num_samples)
        return np.concatenate([self._target(int(i)) for i in idx], axis=0)

    def _target(self, idx: int) -> np.ndarray:
        start_sample, _, ri = self.sample_boundaries[bisect.bisect_right(self._starts, idx) - 1]
        cmd_idx = (idx - start_sample) * self.stride
        return self.recordings[ri].joint_commands[
            cmd_idx: cmd_idx + self.cfg.trajectory_prediction_length].astype(np.float32)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = True, order: np.ndarray | None = None):
        """Yield stacked numpy batch dicts for one epoch; an explicit window
        ``order`` (``oversampled_order``) overrides ``shuffle`` / ``seed``."""
        if order is None:
            order = np.arange(len(self))
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
        limit = len(order) - (len(order) % batch_size if drop_remainder else 0)
        for i in range(0, limit, batch_size):
            chunk = [self[int(j)] for j in order[i: i + batch_size]]
            yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
