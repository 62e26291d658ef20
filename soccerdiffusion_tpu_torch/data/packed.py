"""Packed dataset: flat contiguous arrays, windows assembled per batch
(counterpart of ``soccerdiffusion_tpu/data/packed.py``).

All recordings are packed once into flat float32 row arrays (the five-dim
IMU conversion and the game-state forward fill happen at pack time) and the
frames into one uint8 array; a batch is assembled by slicing, with the
window and padding semantics of ``WindowedDataset``. Frames stay uint8 and
travel as ``image_u8`` with an ``image_valid`` mask: the [0, 1] scale and
the ImageNet normalisation happen on the card, folded into the ViT's patch
embedding (``models/vision.py``) or in ``data/pipeline.prepare_batch``.
``prepatchify_images`` lays the frames out as ViT patches once, on the host.

The assembly is the JAX package's numpy path (``_assemble_numpy``,
``_assemble_images``), so a seed gives the same batches. The JAX package's
C++ ``framepack`` assembler, ``save`` / ``load`` and the SQLite source are
not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data.dataset import IDENTITY_QUAT, WindowedDataset, np_quats_to_5d
from soccerdiffusion_tpu_torch.data.pipeline import patchify_frames
from soccerdiffusion_tpu_torch.data.schema import RobotState

_FIVE_DIM_IDENTITY = np.array([1.0, 0.0, 0.0, 0.0, 1.0], dtype=np.float32)


class PackedDataset:
    """Flat-array batches with the WindowedDataset sample contract."""

    def __init__(self, cmds: np.ndarray, states: np.ndarray, rots: np.ndarray, gs: np.ndarray,
                 rec_row_starts: np.ndarray, rec_lengths: np.ndarray, config: ModelConfig,
                 trajectory_stride: int = 1, images: np.ndarray | None = None,
                 img_stamps: np.ndarray | None = None, img_rec_starts: np.ndarray | None = None,
                 img_rec_counts: np.ndarray | None = None, sampling_rate: int = 100,
                 max_fps_video: int = 10):
        self.cmds = np.ascontiguousarray(cmds, dtype=np.float32)  # (rows, J)
        self.states = np.ascontiguousarray(states, dtype=np.float32)
        self.rots = np.ascontiguousarray(rots, dtype=np.float32)  # (rows, 4 or 5)
        self.gs = np.ascontiguousarray(gs, dtype=np.int32)  # (rows,) forward-filled
        self.rec_row_starts = np.asarray(rec_row_starts, dtype=np.int64)
        self.rec_lengths = np.asarray(rec_lengths, dtype=np.int64)
        self.cfg = config
        self.stride = trajectory_stride
        self.images = images  # (frames, res, res, 3) or (frames, patches, P*P*3) uint8
        self.img_stamps = None if img_stamps is None else np.asarray(img_stamps, np.float32)
        self.img_rec_starts = None if img_rec_starts is None else np.asarray(img_rec_starts, np.int64)
        self.img_rec_counts = None if img_rec_counts is None else np.asarray(img_rec_counts, np.int64)
        self.sampling_rate = sampling_rate
        self.max_fps_video = max_fps_video
        self.rot_pad = (_FIVE_DIM_IDENTITY if self.rots.shape[1] == 5 else IDENTITY_QUAT).copy()
        counts = np.maximum(0, (self.rec_lengths - config.trajectory_prediction_length)
                            // trajectory_stride)
        self._cum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.num_samples = int(self._cum[-1])

    @classmethod
    def from_windowed(cls, ds: WindowedDataset) -> "PackedDataset":
        """Pack a ``WindowedDataset``'s recordings (frames must already be
        at the config's resolution)."""
        cfg = ds.cfg
        cmds, states, rots, gs, starts, lengths = [], [], [], [], [], []
        row = 0
        for rec in ds.recordings:
            n = len(rec.joint_commands)
            starts.append(row)
            lengths.append(n)
            row += n
            cmds.append(rec.joint_commands)
            states.append(rec.joint_states)
            five = cfg.imu_orientation_embedding_method == "five_dim"
            rots.append(np_quats_to_5d(rec.rotations) if five else rec.rotations)
            pos = np.searchsorted(rec.game_state_stamps, np.arange(n) / ds.sampling_rate,
                                  side="right") - 1
            gs.append(np.where(pos >= 0, rec.game_states[np.maximum(pos, 0)],
                               int(RobotState.UNKNOWN)).astype(np.int32))
        images = img_stamps = img_starts = img_counts = None
        if cfg.use_images:
            res = cfg.image_resolution
            frames, stamps_all, img_starts, img_counts = [], [], [], []
            for rec in ds.recordings:
                img_starts.append(sum(img_counts))
                count = 0 if rec.images is None else len(rec.image_stamps)
                img_counts.append(count)
                for k in range(count):
                    if rec.images[k].shape[:2] != (res, res):
                        raise NotImplementedError(
                            f"a {rec.images[k].shape[1]}x{rec.images[k].shape[0]} frame needs a "
                            f"resize to {res} px, which is not ported (see ROADMAP.md, 'H100 port')")
                    frames.append(rec.images[k])
                if count:
                    stamps_all.append(rec.image_stamps)
            images = np.stack(frames) if frames else np.zeros((0, res, res, 3), np.uint8)
            img_stamps = np.concatenate(stamps_all) if stamps_all else np.zeros((0,), np.float32)
        return cls(np.concatenate(cmds), np.concatenate(states), np.concatenate(rots),
                   np.concatenate(gs), np.asarray(starts), np.asarray(lengths), cfg, ds.stride,
                   images=images, img_stamps=img_stamps, img_rec_starts=img_starts,
                   img_rec_counts=img_counts, sampling_rate=ds.sampling_rate,
                   max_fps_video=ds.max_fps_video)

    def __len__(self) -> int:
        return self.num_samples

    def _locate(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rec = np.searchsorted(self._cum, idx, side="right") - 1
        local = (idx - self._cum[rec]) * self.stride
        return self.rec_row_starts[rec], local.astype(np.int64), rec

    def assemble(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        """The batch of global window ``indices``."""
        cfg = self.cfg
        b = len(indices)
        rec_starts, local_idx, rec_ids = self._locate(np.asarray(indices, dtype=np.int64))
        out = {"joint_command": np.empty((b, cfg.trajectory_prediction_length, cfg.num_joints),
                                         np.float32)}
        if cfg.use_action_history:
            out["joint_command_history"] = np.empty((b, cfg.action_context_length, cfg.num_joints),
                                                    np.float32)
        if cfg.use_joint_states:
            out["joint_state"] = np.empty((b, cfg.joint_state_context_length, cfg.num_joints),
                                          np.float32)
        if cfg.use_imu:
            out["rotation"] = np.empty((b, cfg.imu_context_length, self.rots.shape[1]), np.float32)
        if cfg.use_gamestate:
            out["game_state"] = np.empty((b,), np.int32)
        self._assemble_rows(rec_starts, local_idx, out)
        if cfg.use_images and self.images is not None:
            self._assemble_images(rec_ids, local_idx, out)
        return out

    def _assemble_rows(self, rec_starts, local_idx, out) -> None:
        cfg = self.cfg

        def hist_window(src, start, end, length, pad_row):
            window = src[start + max(0, end - length): start + end]
            if len(window) < length:
                window = np.concatenate([np.tile(pad_row, (length - len(window), 1)), window])
            return window

        zero = np.zeros((1, cfg.num_joints), np.float32)
        for i, (rs, li) in enumerate(zip(rec_starts, local_idx)):
            rs, li = int(rs), int(li)
            out["joint_command"][i] = self.cmds[rs + li: rs + li + cfg.trajectory_prediction_length]
            if cfg.use_action_history:
                out["joint_command_history"][i] = hist_window(self.cmds, rs, li,
                                                              cfg.action_context_length, zero)
            if cfg.use_joint_states:
                out["joint_state"][i] = hist_window(self.states, rs, li,
                                                    cfg.joint_state_context_length, zero)
            if cfg.use_imu:
                out["rotation"][i] = hist_window(self.rots, rs, li, cfg.imu_context_length,
                                                 self.rot_pad[None])
            if cfg.use_gamestate:
                out["game_state"][i] = self.gs[rs + li]

    def _assemble_images(self, rec_ids, local_idx, out) -> None:
        """uint8 frame windows with ``WindowedDataset._image_window``'s
        selection; padded slots are zero with ``image_valid`` 0. The gather
        takes whatever layout the frames are stored in."""
        F = self.cfg.image_context_length
        b = len(rec_ids)
        context_len = (F + 1) / self.max_fps_video
        u8 = np.zeros((b, F) + self.images.shape[1:], dtype=np.uint8)
        valid = np.zeros((b, F), dtype=np.float32)
        stamps_out = np.empty((b, F), dtype=np.float32)
        for i, (ri, li) in enumerate(zip(rec_ids, local_idx)):
            stamp = float(li) / self.sampling_rate
            g0, cnt = self.img_rec_starts[ri], self.img_rec_counts[ri]
            rec_stamps = self.img_stamps[g0: g0 + cnt]
            lo = np.searchsorted(rec_stamps, stamp - context_len, side="left")
            hi = np.searchsorted(rec_stamps, stamp, side="right")
            sel = np.arange(lo, hi)[-F:]
            stamps_out[i] = stamp - context_len
            if len(sel):
                u8[i, F - len(sel):] = self.images[g0 + sel[0]: g0 + sel[-1] + 1]
                valid[i, F - len(sel):] = 1.0
                stamps_out[i, F - len(sel):] = rec_stamps[sel]
        out["image_u8"] = u8
        out["image_valid"] = valid
        out["image_stamps"] = stamps_out

    def prepatchify_images(self, patch: int) -> None:
        """Lay the stored frames out as ViT patches, once, on the host:
        (frames, res, res, 3) -> (frames, (res // P)^2, P*P*3) uint8.
        Batches then carry ``image_u8`` pre-patchified."""
        if self.images is None or self.images.ndim == 3:
            return  # no images, or already patchified
        self.images = np.ascontiguousarray(patchify_frames(np.asarray(self.images), patch))

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = True, order: np.ndarray | None = None):
        """Yield one epoch of batches; an explicit window ``order`` overrides
        ``shuffle`` / ``seed``."""
        if order is None:
            order = np.arange(len(self))
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
        limit = len(order) - (len(order) % batch_size if drop_remainder else 0)
        for i in range(0, limit, batch_size):
            yield self.assemble(order[i: i + batch_size])

    def image_boundary_indices(self) -> np.ndarray:
        """Window indices whose stamp coincides with an image stamp
        (``WindowedDataset.image_boundary_indices``' contract)."""
        if not self.cfg.use_images or self.img_stamps is None:
            return np.asarray([], dtype=np.int64)
        out = []
        half_tick = 0.5 / self.sampling_rate
        for r in range(len(self.rec_lengths)):
            n_win = int(self._cum[r + 1] - self._cum[r])
            s0, cnt = int(self.img_rec_starts[r]), int(self.img_rec_counts[r])
            stamps = np.asarray(self.img_stamps[s0:s0 + cnt], dtype=np.float64)
            if not len(stamps):
                continue
            win_stamps = np.arange(n_win) * self.stride / self.sampling_rate
            k = np.searchsorted(stamps, win_stamps + half_tick) - 1
            hit = (k >= 0) & (np.abs(stamps[np.maximum(k, 0)] - win_stamps) < half_tick)
            out.append(np.nonzero(hit)[0] + int(self._cum[r]))
        return np.concatenate(out) if out else np.asarray([], dtype=np.int64)

    def sample_targets(self, num_samples: int, seed: int = 0) -> np.ndarray:
        """Random target chunks stacked along time, for ``Normalizer.fit``
        (the batch's ``joint_command`` rows, without assembling the rest)."""
        idx = np.random.default_rng(seed).integers(0, len(self), size=num_samples)
        rec_starts, local_idx, _ = self._locate(idx)
        P = self.cfg.trajectory_prediction_length
        return np.concatenate([self.cmds[rs + li: rs + li + P]
                               for rs, li in zip(rec_starts, local_idx)], axis=0)
