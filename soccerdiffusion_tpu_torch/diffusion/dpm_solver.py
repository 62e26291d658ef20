"""Linear per-step solver table and sampler (counterpart of
``soccerdiffusion_tpu/diffusion/dpm_solver.py``).

Every step of first-order DDIM and of DPM-Solver++(2M) is linear in
(x_t, eps, x0_prev) with coefficients that depend only on the schedule and
the timestep sequence, so one host-side (T, 5) float32 table [A, B, C, P, Q]

    x_next = A x + B eps + C x0cache ;  x0cache_next = P x + Q eps

drives both the plain loop here and the whole-chunk CUDA kernel
(``ops/fused_chunk.py``). The table is computed in float64 numpy.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from soccerdiffusion_tpu_torch.diffusion.ddim import alpha_bar, ddim_timesteps
from soccerdiffusion_tpu_torch.diffusion.schedule import DiffusionSchedule


def parse_solver(solver: str) -> tuple[str, str]:
    """Split "name[@spacing]" into (name, spacing); name is ddim or dpmpp,
    spacing is "leading" (default, the deployment form) or "lambda"
    (log-SNR-uniform)."""
    name, _, spacing = solver.partition("@")
    spacing = spacing or "leading"
    if name not in ("ddim", "dpmpp"):
        raise ValueError(f"unknown solver {solver!r}")
    if spacing not in ("leading", "lambda"):
        raise ValueError(f"unknown timestep spacing {spacing!r} in {solver!r}")
    return name, spacing


def solver_label(solver: str, num_steps: int) -> str:
    """The sampler's row label, e.g. ("dpmpp@lambda", 10) -> "dpmpp10_lambda"."""
    name, spacing = parse_solver(solver)
    return f"{name}{num_steps}" + ("" if spacing == "leading" else f"_{spacing}")


def solver_timesteps(schedule: DiffusionSchedule, num_inference_steps: int,
                     spacing: str = "leading") -> np.ndarray:
    """Descending int32 timesteps: "leading" (ddim_timesteps) or "lambda"
    (consecutive half-log-SNR increments as equal as the integer grid allows)."""
    if spacing == "leading":
        return ddim_timesteps(schedule.num_train_timesteps, num_inference_steps)
    if spacing != "lambda":
        raise ValueError(f"unknown spacing {spacing!r}")
    T = schedule.num_train_timesteps
    if num_inference_steps > T:
        raise ValueError("num_inference_steps cannot exceed num_train_timesteps")
    acp = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    lam = 0.5 * np.log(acp / (1.0 - acp))
    grid = np.linspace(lam[T - 1], lam[0], num_inference_steps)
    out, prev = [], T
    for g in grid:
        t = min(int(np.abs(lam - g).argmin()), prev - 1)
        out.append(t)
        prev = t
    if out[-1] < 0:
        raise ValueError(f"cannot place {num_inference_steps} distinct "
                         f"lambda-spaced steps on a {T}-step schedule")
    return np.asarray(out, dtype=np.int32)


def solver_coef_table(schedule: DiffusionSchedule, num_inference_steps: int,
                      solver: str = "ddim", lower_order_final: bool = True) -> np.ndarray:
    """(T, 5) float32 [A, B, C, P, Q]; DDIM is the C = 0 case.

    DPM-Solver++(2M) with alpha = sqrt(abar), sigma = sqrt(1 - abar),
    lambda = log(alpha / sigma), h = lambda_p - lambda_c and the midpoint
    correction c = h / (2 h_prev); the first step, the final step (with
    ``lower_order_final``) and the terminal sigma_p = 0 step are first order."""
    name, spacing = parse_solver(solver)
    T = num_inference_steps
    ts = np.asarray(solver_timesteps(schedule, T, spacing), dtype=np.int64)
    out = np.zeros((T, 5), dtype=np.float64)
    h_prev = None
    for i, t in enumerate(ts):
        prev_t = int(ts[i + 1]) if i + 1 < len(ts) else -1
        a_c2, a_p2 = alpha_bar(schedule, int(t)), alpha_bar(schedule, prev_t)
        alpha_c, sigma_c = np.sqrt(a_c2), np.sqrt(1.0 - a_c2)
        alpha_p, sigma_p = np.sqrt(a_p2), np.sqrt(1.0 - a_p2)
        P = 1.0 / alpha_c
        Q = -sigma_c / alpha_c
        if name == "ddim":
            A, B, C = alpha_p * P, alpha_p * Q + sigma_p, 0.0
        else:
            lam_c = np.log(alpha_c / sigma_c)
            if sigma_p == 0.0:
                phi, sig_ratio, h = 1.0, 0.0, np.inf
            else:
                h = np.log(alpha_p / sigma_p) - lam_c
                phi = 1.0 - np.exp(-h)
                sig_ratio = sigma_p / sigma_c
            first_order = (h_prev is None or (lower_order_final and i == T - 1)
                           or not np.isfinite(h))
            c = 0.0 if first_order else h / (2.0 * h_prev)
            A = sig_ratio + alpha_p * phi * (1.0 + c) * P
            B = alpha_p * phi * (1.0 + c) * Q
            C = -alpha_p * phi * c
            h_prev = h
        out[i] = (A, B, C, P, Q)
    return out.astype(np.float32)


def solver_sample(schedule: DiffusionSchedule,
                  denoise_fn: Callable[[torch.Tensor, int], torch.Tensor],
                  x_t: torch.Tensor, num_inference_steps: int,
                  solver: str = "dpmpp") -> torch.Tensor:
    """Sampling loop for either solver; ``denoise_fn(x, t)`` predicts epsilon
    at the int timestep t. Solver math in float32."""
    _, spacing = parse_solver(solver)
    ts = solver_timesteps(schedule, num_inference_steps, spacing)
    coefs = solver_coef_table(schedule, num_inference_steps, solver).tolist()
    x = x_t.float()
    x0cache = torch.zeros_like(x)
    for t, (a, b, c, p, q) in zip(ts, coefs):
        eps = denoise_fn(x.to(x_t.dtype), int(t)).float()
        x, x0cache = a * x + b * eps + c * x0cache, p * x + q * eps
    return x.to(x_t.dtype)
