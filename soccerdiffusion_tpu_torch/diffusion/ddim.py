"""Forward diffusion and the DDIM and DDPM reverse processes (counterpart
of ``soccerdiffusion_tpu/diffusion/ddim.py``).

DDIM: epsilon prediction, eta=0, diffusers' default "leading" timestep
spacing, ``clip_sample`` off by default. DDPM: the ancestral sampler over
every train timestep (Ho et al. 2020), no noise at t = 0. All solver math
is float32 whatever the activations' dtype; the samplers are plain Python
loops over the timesteps.
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


def ddpm_step(schedule: DiffusionSchedule, eps_pred: torch.Tensor, t: int, sample: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """One ancestral DDPM step x_t -> x_{t-1} at a timestep shared by the
    batch (epsilon prediction, no clipping): the posterior mean

      x0_hat = (x_t - sqrt(1-abar_t) eps) / sqrt(abar_t)
      mean   = sqrt(abar_prev) beta_t / (1-abar_t) x0_hat
               + sqrt(alpha_t) (1-abar_prev) / (1-abar_t) x_t

    plus sqrt(beta_t (1-abar_prev) / (1-abar_t)) ``noise`` where t > 0."""
    x, eps = sample.float(), eps_pred.float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    beta_t = f32(float(schedule.betas[int(t)]))
    abar_t = f32(alpha_bar(schedule, int(t)))
    abar_prev = f32(alpha_bar(schedule, int(t) - 1))
    x0_hat = (x - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
    coef_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
    coef_xt = torch.sqrt(1.0 - beta_t) * (1.0 - abar_prev) / (1.0 - abar_t)
    x_prev = coef_x0 * x0_hat + coef_xt * x
    if int(t) > 0:
        x_prev = x_prev + torch.sqrt(beta_t * (1.0 - abar_prev) / (1.0 - abar_t)) * noise.float()
    return x_prev.to(sample.dtype)


def ddpm_sample(schedule: DiffusionSchedule,
                denoise_fn: Callable[[torch.Tensor, int], torch.Tensor], x_t: torch.Tensor,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """Ancestral DDPM from t = T-1 down to 0; ``denoise_fn(x, t)`` predicts
    epsilon at the int timestep t. The step noise is ``noise[T-1-i]`` of a
    given (T, *x.shape) tensor at the i-th step, else drawn from
    ``generator`` on ``x_t``'s device, one draw a step."""
    T = schedule.num_train_timesteps
    if noise is not None and tuple(noise.shape) != (T, *x_t.shape):
        raise ValueError(f"noise must be (T, *x.shape) = {(T, *x_t.shape)}, "
                         f"got {tuple(noise.shape)}")
    x = x_t
    for i, t in enumerate(range(T - 1, -1, -1)):
        eps = denoise_fn(x, t)
        z = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=torch.float32)
        x = ddpm_step(schedule, eps, t, x, z)
    return x
