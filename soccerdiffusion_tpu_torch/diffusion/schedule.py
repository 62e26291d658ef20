"""Noise schedules (counterpart of ``soccerdiffusion_tpu/diffusion/schedule.py``).

Host numpy: betas and their cumulative product are computed in float64 and
stored as float32, exactly as the JAX package stores them, so the timestep
and coefficient tables built from them agree bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tables.

    betas / alphas_cumprod: (T,) float32 numpy arrays; final_alpha_cumprod:
    the alpha-bar of the step past t=0 (1.0 with diffusers'
    ``set_alpha_to_one=True`` default)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int
    final_alpha_cumprod: float


def squaredcos_cap_v2_betas(num_train_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Cosine alpha-bar schedule betas (improved-DDPM, s=0.008, capped)."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.empty(num_train_timesteps, dtype=np.float64)
    for i in range(num_train_timesteps):
        t1 = i / num_train_timesteps
        t2 = (i + 1) / num_train_timesteps
        betas[i] = min(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)
    return betas.astype(np.float32)


def linear_betas(num_train_timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64).astype(np.float32)


def scaled_linear_betas(num_train_timesteps: int, beta_start: float = 0.00085, beta_end: float = 0.012) -> np.ndarray:
    return (np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2).astype(np.float32)


_BETA_FNS = {
    "squaredcos_cap_v2": squaredcos_cap_v2_betas,
    "linear": linear_betas,
    "scaled_linear": scaled_linear_betas,
}


def make_schedule(num_train_timesteps: int = 1000, beta_schedule: str = "squaredcos_cap_v2",
                  set_alpha_to_one: bool = True) -> DiffusionSchedule:
    if beta_schedule not in _BETA_FNS:
        raise ValueError(f"unknown beta_schedule: {beta_schedule}")
    betas = _BETA_FNS[beta_schedule](num_train_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)
    final_alpha_cumprod = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    return DiffusionSchedule(betas=betas, alphas_cumprod=alphas_cumprod,
                             num_train_timesteps=num_train_timesteps,
                             final_alpha_cumprod=final_alpha_cumprod)
