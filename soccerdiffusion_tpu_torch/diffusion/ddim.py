"""Forward diffusion and the DDIM reverse process (counterpart of
``soccerdiffusion_tpu/diffusion/ddim.py``).

Epsilon prediction, eta=0, diffusers' default "leading" timestep spacing,
``clip_sample`` off by default. All solver math is float32 whatever the
activations' dtype; the sampler is a plain Python loop over the timesteps.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from soccerdiffusion_tpu_torch.diffusion.schedule import DiffusionSchedule


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps for
    per-element int timesteps t (B,), in float32, cast back to x0's dtype."""
    abar = torch.as_tensor(np.asarray(schedule.alphas_cumprod, np.float32),
                           device=x0.device)[t.long()]
    abar = abar.reshape(abar.shape + (1,) * (x0.ndim - abar.ndim))
    out = torch.sqrt(abar) * x0.float() + torch.sqrt(1.0 - abar) * noise.float()
    return out.to(x0.dtype)


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending timesteps with "leading" spacing: T=1000, n=30 -> [957, ..., 33, 0]."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError("num_inference_steps cannot exceed num_train_timesteps")
    step_ratio = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy().astype(np.int32)


def alpha_bar(schedule: DiffusionSchedule, t: int) -> float:
    """alpha-bar at t, with final_alpha_cumprod for t < 0 ('fully denoised')."""
    return float(schedule.alphas_cumprod[t]) if t >= 0 else float(schedule.final_alpha_cumprod)


def ddim_step(schedule: DiffusionSchedule, eps_pred: torch.Tensor, t: int, prev_t: int,
              sample: torch.Tensor, *, clip_x0: float | None = None) -> torch.Tensor:
    """One DDIM step x_t -> x_prev at a timestep shared by the batch:

      x0_hat = (x_t - sqrt(1-abar_t) eps) / sqrt(abar_t)
      x_prev = sqrt(abar_prev) x0_hat + sqrt(1-abar_prev) eps

    ``clip_x0`` clamps x0_hat and recomputes eps from it (diffusers'
    ``clip_sample``)."""
    x = sample.float()
    eps = eps_pred.float()
    abar_t = torch.tensor(alpha_bar(schedule, int(t)), dtype=torch.float32)
    abar_prev = torch.tensor(alpha_bar(schedule, int(prev_t)), dtype=torch.float32)
    x0_hat = (x - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
    if clip_x0 is not None:
        x0_hat = x0_hat.clamp(-clip_x0, clip_x0)
        eps = (x - torch.sqrt(abar_t) * x0_hat) / torch.sqrt(1.0 - abar_t)
    x_prev = torch.sqrt(abar_prev) * x0_hat + torch.sqrt(1.0 - abar_prev) * eps
    return x_prev.to(sample.dtype)


def ddim_sample(schedule: DiffusionSchedule,
                denoise_fn: Callable[[torch.Tensor, int], torch.Tensor],
                x_t: torch.Tensor, num_inference_steps: int, *,
                clip_x0: float | None = None) -> torch.Tensor:
    """Full DDIM loop; ``denoise_fn(x, t)`` predicts epsilon at the int timestep t."""
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    x = x_t
    for t in ddim_timesteps(schedule.num_train_timesteps, num_inference_steps):
        eps = denoise_fn(x, int(t))
        x = ddim_step(schedule, eps, int(t), int(t) - step_ratio, x, clip_x0=clip_x0)
    return x
