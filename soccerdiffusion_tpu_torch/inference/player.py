"""Chunk playback: the point of a published action chunk that is active at a
given time (counterpart of ``soccerdiffusion_tpu/inference/player.py``).

At each control tick the player takes the latest trajectory point whose
time offset has passed, clamped to the chunk's last point. The index is
computed in float64: the clock is ``time.monotonic()``, and at an uptime
of 1e6 s float32's spacing is 62.5 ms, more than three 20 ms ticks.
"""

from __future__ import annotations

import numpy as np


def select_action_index(chunk_len: int, chunk_start_time, now, rate_hz: float = 50.0):
    """Index of the active point, floor((now - start) * rate) clamped to
    [0, chunk_len - 1]; an int for scalar times, else an int64 array."""
    elapsed = np.asarray(now, dtype=np.float64) - np.asarray(chunk_start_time, dtype=np.float64)
    idx = np.clip(np.floor(elapsed * rate_hz), 0, chunk_len - 1).astype(np.int64)
    return int(idx) if idx.ndim == 0 else idx


def select_action(chunk: np.ndarray, chunk_start_time, now, rate_hz: float = 50.0) -> np.ndarray:
    """chunk: (..., P, J); returns the (..., J) command active at ``now``
    (times broadcast against the chunk's leading axes)."""
    chunk = np.asarray(chunk)
    idx = select_action_index(chunk.shape[-2], chunk_start_time, now, rate_hz)
    if np.ndim(idx) == 0:
        return chunk[..., idx, :]
    return np.take_along_axis(chunk, idx[..., None, None], axis=-2)[..., 0, :]
