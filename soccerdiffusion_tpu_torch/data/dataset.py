"""Windowed training dataset over in-memory recording arrays (counterpart of
``soccerdiffusion_tpu/data/dataset.py``, proprioceptive configs).

Each recording's time series are held as contiguous numpy arrays and
windows are gathered by slicing, with the JAX package's (and the
reference's) padding semantics:

  * history windows are left-padded with zeros;
  * IMU windows are left-padded with the identity quaternion;
  * the game state is the last state at or before the stamp, UNKNOWN if none.

Index space: per recording (n_commands - future_len) / stride windows,
concatenated. Given the same seed, ``batches`` and ``sample_targets`` give
the same arrays as the JAX package. Image windows and ``from_sqlite`` are
not ported yet.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data.schema import RobotState

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


@dataclass
class RecordingArrays:
    """One recording's synchronized time series, in canonical joint order."""

    joint_commands: np.ndarray  # (n, J)
    joint_states: np.ndarray  # (n, J)
    rotations: np.ndarray  # (n, 4) xyzw
    game_states: np.ndarray  # (m,) int32, sorted by stamp
    game_state_stamps: np.ndarray  # (m,) float32


class WindowedDataset:
    def __init__(self, recordings: list[RecordingArrays], config: ModelConfig,
                 trajectory_stride: int = 1, sampling_rate: int = 100):
        if config.use_images:
            raise NotImplementedError("image windows come with the image path, which is not "
                                      "ported yet (see ROADMAP.md)")
        if not recordings:
            raise ValueError("no recordings")
        self.recordings = recordings
        self.cfg = config
        self.stride = trajectory_stride
        self.sampling_rate = sampling_rate
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
    def from_dummy(cls, dummy_recordings, config: ModelConfig, **kwargs) -> "WindowedDataset":
        """Wrap ``generate_dummy_arrays`` output."""
        recs = [RecordingArrays(
            joint_commands=d.joint_commands[:, : config.num_joints],
            joint_states=d.joint_states[:, : config.num_joints],
            rotations=d.rotations,
            game_states=d.game_states,
            game_state_stamps=(np.arange(len(d.game_states)) / 100).astype(np.float32))
            for d in dummy_recordings]
        return cls(recs, config, **kwargs)

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
        if cfg.use_gamestate:
            gi = np.searchsorted(rec.game_state_stamps, stamp, side="right") - 1
            out["game_state"] = np.int32(rec.game_states[gi] if gi >= 0 else int(RobotState.UNKNOWN))
        return out

    def sample_targets(self, num_samples: int, seed: int = 0) -> np.ndarray:
        """Random target chunks stacked along time, for ``Normalizer.fit``."""
        idx = np.random.default_rng(seed).integers(0, len(self), size=num_samples)
        return np.concatenate([self[int(i)]["joint_command"] for i in idx], axis=0)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = True):
        """Yield stacked numpy batch dicts for one epoch."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        limit = len(order) - (len(order) % batch_size if drop_remainder else 0)
        for i in range(0, limit, batch_size):
            chunk = [self[int(j)] for j in order[i: i + batch_size]]
            yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
