"""Synthetic recordings as numpy arrays (counterpart of
``generate_dummy_arrays`` in ``soccerdiffusion_tpu/data/dummy.py``, the
"decorative" task without images).

Same draws from the same ``numpy`` generator as the JAX package, so a seed
gives bit-identical arrays: per recording, sinusoid joint commands and
joint states shifted by +pi, sinusoid pseudo-quaternions, uniform game
states, and the image stamps of a 10-frame cadence (no images).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def _sinusoid_joints(n: int, num_joints: int, rng: np.random.Generator, speed: float = 0.2) -> np.ndarray:
    """sin(speed * i + offset_j) + pi per joint, inside [0, 2 pi)."""
    offsets = rng.random(num_joints)
    i = np.arange(n, dtype=np.float64)[:, None]
    return (np.sin(speed * i + offsets[None, :]) + math.pi).astype(np.float32)


def _sinusoid_rotations(n: int, rng: np.random.Generator, speed: float = 0.1) -> np.ndarray:
    """Per-component sinusoids in [-1, 1] (deliberately not unit quaternions)."""
    shifts = rng.random(4)
    i = np.arange(n, dtype=np.float64)[:, None]
    return np.sin(i * speed + shifts[None, :]).astype(np.float32)


def _stamps_f32_floor(tick_indices: np.ndarray, sampling_rate: int) -> np.ndarray:
    """Largest float32 <= tick / rate."""
    exact = tick_indices / sampling_rate
    stamps = exact.astype(np.float32)
    return np.where(stamps.astype(np.float64) > exact,
                    np.nextafter(stamps, np.float32(-np.inf)), stamps)


@dataclass
class DummyRecording:
    joint_commands: np.ndarray  # (n, J) float32, [0, 2pi)
    joint_states: np.ndarray  # (n, J) float32, [0, 2pi)
    rotations: np.ndarray  # (n, 4) float32 xyzw
    game_states: np.ndarray  # (n,) int32 in [0, 4)
    image_stamps: np.ndarray  # (n_img,) float32 seconds


def generate_dummy_arrays(num_recordings: int = 2, num_samples: int = 500, num_joints: int = 20,
                          image_step: int = 10, image_size: int = 480, with_images: bool = False,
                          seed: int = 0, sampling_rate: int = 100,
                          task: str = "decorative") -> list[DummyRecording]:
    """Array-tier dummy data, one entry per recording; stamps are
    i / sampling_rate. ``image_size`` is accepted for the JAX signature."""
    if task == "vision" or with_images:
        raise NotImplementedError("dummy images (and the 'vision' task) come with the image "
                                  "path, which is not ported yet (see ROADMAP.md)")
    if task != "decorative":
        raise ValueError(f"unknown dummy task: {task!r}")
    rng = np.random.default_rng(seed)
    recordings = []
    for _ in range(num_recordings):
        recordings.append(DummyRecording(
            joint_commands=_sinusoid_joints(num_samples, num_joints, rng),
            joint_states=_sinusoid_joints(num_samples, num_joints, rng),
            rotations=_sinusoid_rotations(num_samples, rng),
            game_states=rng.integers(0, 4, size=num_samples).astype(np.int32),
            image_stamps=_stamps_f32_floor(np.arange(0, num_samples, image_step), sampling_rate),
        ))
    return recordings
