"""Quaternion / angle utilities on tensors (counterpart of
``soccerdiffusion_tpu/utils/geometry.py``).

Batch-first closed forms of the reference's utils/utils.py:9-75 (which
loops over transforms3d's quat2axangle per sample): branch-free, so they
run on whole batches on the card. ``data/dataset.py:np_quats_to_5d`` is the
numpy twin the data pipeline uses.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def xyzw2wxyz(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> wxyz."""
    return torch.roll(quat, 1, dims=-1)


def wxyz2xyzw(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> xyzw."""
    return torch.roll(quat, -1, dims=-1)


def quats_to_5d(quats_xyzw: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw quaternions -> (..., 5) [axis_x, axis_y, axis_z, sin a, cos a].

    The reference's axis-angle with the angle as a continuous sin / cos pair
    (utils/utils.py:9-25), with transforms3d's conventions: non-unit
    quaternions are normalised, and the identity-rotation limit takes the
    x-axis (1, 0, 0) at angle 0.
    """
    norm = torch.linalg.vector_norm(quats_xyzw, dim=-1, keepdim=True)
    q = quats_xyzw / torch.clamp(norm, min=1e-12)
    xyz, w = q[..., :3], q[..., 3]
    len_xyz = torch.linalg.vector_norm(xyz, dim=-1)
    axis = xyz / torch.clamp(len_xyz, min=1e-12)[..., None]
    degenerate = len_xyz < 1e-6
    default_axis = torch.zeros_like(axis)
    default_axis[..., 0] = 1.0
    axis = torch.where(degenerate[..., None], default_axis, axis)
    angle = torch.where(degenerate, torch.zeros_like(w), 2.0 * torch.atan2(len_xyz, w))
    return torch.cat([axis, torch.sin(angle)[..., None], torch.cos(angle)[..., None]], dim=-1)


def shift_radian_to_positive_range(radian: torch.Tensor) -> torch.Tensor:
    """[-pi, pi] principal range -> [0, 2 pi): (x + 3 pi) mod 2 pi, the
    reference's formula (utils/utils.py:47-54)."""
    return torch.remainder(radian + 3.0 * math.pi, TWO_PI)


def shift_radian_to_symmetric_range(radian: torch.Tensor) -> torch.Tensor:
    """[0, 2 pi) -> [-pi, pi), the inverse shift used when feeding actions
    back (the reference's ml/inference/ros.py:315-318 applies the -pi wrap)."""
    return torch.remainder(radian + math.pi, TWO_PI) - math.pi
