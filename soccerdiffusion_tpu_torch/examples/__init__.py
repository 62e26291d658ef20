"""The example zoo on the port (counterparts of the scripts in ``examples/``
at the repository root, the reference's preliminary research lineage,
SURVEY.md §2.8). Each runs as ``python -m
soccerdiffusion_tpu_torch.examples.<name>`` with the JAX script's arguments
and PASS line, plus ``--device`` (default cuda; ``--device cpu`` for the
CPU), and has a ``main(argv=None)``."""

from __future__ import annotations

import numpy as np
import torch

from soccerdiffusion_tpu_torch.data.pipeline import to_tensors


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r} requested but CUDA is not available "
                           "(pass --device cpu for the CPU)")
    return device


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: v.to(device) for k, v in to_tensors(batch).items()}


def lecun_normal(rng: np.random.Generator, shape: tuple, fan_in: int) -> np.ndarray:
    """flax's default kernel initialiser drawn with numpy: a normal truncated
    at 2 std, scaled to std sqrt(1 / fan_in) (float32)."""
    z = rng.standard_normal(shape)
    while (bad := np.abs(z) > 2.0).any():
        z[bad] = rng.standard_normal(int(bad.sum()))
    return (z * np.sqrt(1.0 / fan_in) / 0.87962566103423978).astype(np.float32)
