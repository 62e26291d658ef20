"""Packed dataset: flat contiguous arrays, windows assembled per batch
(counterpart of ``soccerdiffusion_tpu/data/packed.py``).

All recordings are packed once into flat float32 row arrays (the five-dim
IMU conversion and the game-state forward fill happen at pack time) and the
frames, resized once to ``image_resolution`` with INTER_AREA
(``data/resize.py``), into one uint8 array; a batch is assembled with the
window and padding semantics of ``WindowedDataset``. Frames stay uint8 and
travel as ``image_u8`` with an ``image_valid`` mask: the [0, 1] scale and
the ImageNet normalisation happen on the card, folded into the ViT's patch
embedding (``models/vision.py``) or in ``data/pipeline.prepare_batch``.
``prepatchify_images`` lays the frames out as ViT patches once, on the host.

The rows are assembled by the multithreaded C++ assembler
(``native/framepack.cpp``, built at first use; ``assembler="native"``, the
default) or by the JAX package's numpy loop (``assembler="numpy"``): the
same batches bit for bit. ``num_threads`` defaults to 1 where the JAX
package starts 8 threads a batch: a B=64 batch's rows take ~0.2 ms to copy
on one thread, and starting threads for them took longer than that
(PERF.md §6, PR 13). ``save`` / ``load`` use the JAX package's file
layout (four ``.npy`` row shards, ``images.npy`` / ``image_stamps.npy`` and
``index.json``), ``load`` memory-maps the shards and the frames, so shards
written by either package load in the other.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import numpy as np

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data.dataset import IDENTITY_QUAT, WindowedDataset, np_quats_to_5d
from soccerdiffusion_tpu_torch.data.pipeline import patchify_frames
from soccerdiffusion_tpu_torch.data.resize import resize_area
from soccerdiffusion_tpu_torch.data.schema import RobotState
from soccerdiffusion_tpu_torch.native.build import load_framepack

ASSEMBLERS = ("native", "numpy")

_FIVE_DIM_IDENTITY = np.array([1.0, 0.0, 0.0, 0.0, 1.0], dtype=np.float32)


class PackedDataset:
    """Flat-array batches with the WindowedDataset sample contract."""

    def __init__(self, cmds: np.ndarray, states: np.ndarray, rots: np.ndarray, gs: np.ndarray,
                 rec_row_starts: np.ndarray, rec_lengths: np.ndarray, config: ModelConfig,
                 trajectory_stride: int = 1, images: np.ndarray | None = None,
                 img_stamps: np.ndarray | None = None, img_rec_starts: np.ndarray | None = None,
                 img_rec_counts: np.ndarray | None = None, sampling_rate: int = 100,
                 max_fps_video: int = 10, num_threads: int = 1, assembler: str = "native"):
        if assembler not in ASSEMBLERS:
            raise ValueError(f"unknown assembler {assembler!r}; expected one of {ASSEMBLERS}")
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
        self.num_threads, self.assembler = num_threads, assembler
        self._lib = load_framepack() if assembler == "native" else None

    @classmethod
    def from_windowed(cls, ds: WindowedDataset, num_threads: int = 1,
                      assembler: str = "native") -> "PackedDataset":
        """Pack a ``WindowedDataset``'s recordings, each frame resized once
        to the config's resolution."""
        cfg = ds.cfg
        lib = load_framepack() if assembler == "native" else None
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
            gs.append(forward_fill(rec.game_state_stamps, rec.game_states, n, ds.sampling_rate,
                                   lib))
        images = img_stamps = img_starts = img_counts = None
        if cfg.use_images:
            res = cfg.image_resolution
            frames, stamps_all, img_starts, img_counts = [], [], [], []
            for rec in ds.recordings:
                img_starts.append(sum(img_counts))
                count = 0 if rec.images is None else len(rec.image_stamps)
                img_counts.append(count)
                frames += [resize_area(rec.images[k], res, res) for k in range(count)]
                if count:
                    stamps_all.append(rec.image_stamps)
            images = np.stack(frames) if frames else np.zeros((0, res, res, 3), np.uint8)
            img_stamps = np.concatenate(stamps_all) if stamps_all else np.zeros((0,), np.float32)
        return cls(np.concatenate(cmds), np.concatenate(states), np.concatenate(rots),
                   np.concatenate(gs), np.asarray(starts), np.asarray(lengths), cfg, ds.stride,
                   images=images, img_stamps=img_stamps, img_rec_starts=img_starts,
                   img_rec_counts=img_counts, sampling_rate=ds.sampling_rate,
                   max_fps_video=ds.max_fps_video, num_threads=num_threads, assembler=assembler)

    def save(self, path: str | Path) -> None:
        """The JAX package's layout under the directory ``path``."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        for name, arr in (("joint_commands", self.cmds), ("joint_states", self.states),
                          ("rotations", self.rots), ("game_states", self.gs)):
            np.save(path / f"{name}.npy", arr)
        if self.images is not None:
            np.save(path / "images.npy", np.ascontiguousarray(self.images))
            np.save(path / "image_stamps.npy", self.img_stamps)
        as_list = lambda a: None if a is None else a.tolist()
        (path / "index.json").write_text(json.dumps({
            "rec_row_starts": self.rec_row_starts.tolist(),
            "rec_lengths": self.rec_lengths.tolist(),
            "num_joints": self.cfg.num_joints,
            "rot_dim": int(self.rots.shape[1]),
            "trajectory_stride": self.stride,
            "sampling_rate": self.sampling_rate,
            "max_fps_video": self.max_fps_video,
            "img_rec_starts": as_list(self.img_rec_starts),
            "img_rec_counts": as_list(self.img_rec_counts),
        }))

    @classmethod
    def load(cls, path: str | Path, config: ModelConfig, num_threads: int = 1,
             assembler: str = "native") -> "PackedDataset":
        """A dataset ``save`` wrote (either package's): the row shards and the
        frames memory-mapped read-only, the frame stamps in memory."""
        path = Path(path)
        meta = json.loads((path / "index.json").read_text())
        shard = lambda name: np.load(path / f"{name}.npy", mmap_mode="r")
        has_images = (path / "images.npy").exists()
        return cls(shard("joint_commands"), shard("joint_states"), shard("rotations"),
                   shard("game_states"), np.asarray(meta["rec_row_starts"]),
                   np.asarray(meta["rec_lengths"]), config, meta["trajectory_stride"],
                   images=shard("images") if has_images else None,
                   img_stamps=np.load(path / "image_stamps.npy") if has_images else None,
                   img_rec_starts=np.asarray(meta["img_rec_starts"]) if has_images else None,
                   img_rec_counts=np.asarray(meta["img_rec_counts"]) if has_images else None,
                   sampling_rate=meta.get("sampling_rate", 100),
                   max_fps_video=meta.get("max_fps_video", 10), num_threads=num_threads,
                   assembler=assembler)

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
        if self._lib is not None:
            self._assemble_native(rec_starts, local_idx, out)
        else:
            self._assemble_rows(rec_starts, local_idx, out)
        if cfg.use_images and self.images is not None:
            self._assemble_images(rec_ids, local_idx, out)
        return out

    def _assemble_native(self, rec_starts, local_idx, out) -> None:
        """``_assemble_rows`` in ``framepack.cpp`` over ``num_threads``
        threads (every array it reads or writes is a contiguous numpy
        array that outlives the call)."""
        cfg = self.cfg
        f32p, i32p, i64p = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_int64))
        rec_starts = np.ascontiguousarray(rec_starts, dtype=np.int64)
        local_idx = np.ascontiguousarray(local_idx, dtype=np.int64)
        ptr = lambda key, typ=f32p: out[key].ctypes.data_as(typ) if key in out else typ()
        self._lib.fp_assemble_batch(
            self.cmds.ctypes.data_as(f32p), self.states.ctypes.data_as(f32p),
            self.rots.ctypes.data_as(f32p), self.gs.ctypes.data_as(i32p),
            cfg.num_joints, self.rots.shape[1],
            rec_starts.ctypes.data_as(i64p), local_idx.ctypes.data_as(i64p),
            len(local_idx), cfg.trajectory_prediction_length,
            cfg.action_context_length if cfg.use_action_history else 0,
            cfg.joint_state_context_length if cfg.use_joint_states else 0,
            cfg.imu_context_length if cfg.use_imu else 0,
            self.rot_pad.ctypes.data_as(f32p),
            ptr("joint_command"), ptr("joint_command_history"), ptr("joint_state"),
            ptr("rotation"), ptr("game_state", i32p), self.num_threads)

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


def forward_fill(stamps: np.ndarray, values: np.ndarray, n: int, sampling_rate: int,
                 lib=None) -> np.ndarray:
    """(n,) int32: per command row i (stamp i / sampling_rate), the last game
    state stamped at or before it, UNKNOWN before the first; with ``lib``
    (the framepack library) in its C loop."""
    if lib is None or not len(stamps):
        pos = np.searchsorted(stamps, np.arange(n) / sampling_rate, side="right") - 1
        return np.where(pos >= 0, values[np.maximum(pos, 0)],
                        int(RobotState.UNKNOWN)).astype(np.int32)
    stamps = np.ascontiguousarray(stamps, dtype=np.float32)
    values = np.ascontiguousarray(values, dtype=np.int32)
    filled = np.empty(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fp_forward_fill_gamestate(stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                  values.ctypes.data_as(i32p), len(stamps),
                                  float(sampling_rate), n, int(RobotState.UNKNOWN),
                                  filled.ctypes.data_as(i32p))
    return filled
