"""Closed-loop divergence: teacher against student under feedback
(counterpart of ``soccerdiffusion_tpu/evaluation/divergence.py``).

Open-loop agreement measures one chunk; a policy is deployed in closed
loop, feeding its own predictions back into the action history, where
small per-chunk errors compound. Two samplers roll through the batched
``RolloutEngine`` (its defaults: the plain sampler) from the same initial
state and the same noise: both rollouts' generators start from the same
seed, so each period draws the same chunk noise and the divergence is the
samplers' difference and its feedback, not sampling luck.

``noise_fn(stream_seed, (num_chunks, B, P, J))``, where given, supplies
every period's noise of a rollout stream instead (the tests hand in the
JAX engine's own draws).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from soccerdiffusion_tpu_torch.diffusion import DiffusionSchedule, solver_label
from soccerdiffusion_tpu_torch.evaluation.openloop import NoiseFn, check_device
from soccerdiffusion_tpu_torch.inference.rollout import RolloutEngine


def rollout_chunks(model, schedule: DiffusionSchedule, normalizer, num_steps: int,
                   distilled: bool, batch_size: int, num_chunks: int, seed: int = 0,
                   solver: str = "ddim", noise: Sequence[torch.Tensor] | None = None,
                   device="cuda") -> np.ndarray:
    """Executed chunks (num_chunks, B, P, J) of one sampler configuration;
    ``noise``, where given, is each period's (B, P, J) chunk noise."""
    device = check_device(model, device)
    engine = RolloutEngine(model, schedule, normalizer, num_inference_steps=num_steps,
                           distilled=distilled, solver=solver, device=device)
    # no prefill: an image config's token cache starts at zero tokens, as the
    # JAX engine's init without variables does
    carry = engine.init(batch_size, torch.Generator(device=device).manual_seed(seed),
                        prefill=False)
    chunks = []
    for i in range(num_chunks):
        carry, executed = engine.replan_period(carry, None if noise is None else noise[i])
        chunks.append(executed)
    return torch.stack(chunks).cpu().numpy()


def _stream(noise_fn: NoiseFn | None, stream_seed: int, num_chunks: int, batch_size: int,
            cfg) -> list[torch.Tensor] | None:
    if noise_fn is None:
        return None
    shape = (num_chunks, batch_size, cfg.trajectory_prediction_length, cfg.num_joints)
    return list(noise_fn(stream_seed, shape).unbind(0))


def closed_loop_divergence(teacher, student, schedule: DiffusionSchedule, normalizer,
                           teacher_steps: int, student_steps: int, student_distilled: bool,
                           batch_size: int = 64, num_chunks: int = 10, seed: int = 0,
                           student_solver: str = "ddim", noise_fn: NoiseFn | None = None,
                           device="cuda") -> dict:
    """Per-period mean |joint delta| between the teacher's and the
    student's rollouts: the curve (radians, one value a replan period), its
    final and mean values, and the teacher's own per-tick action scale."""
    noise = _stream(noise_fn, seed, num_chunks, batch_size, teacher.config)
    t_chunks = rollout_chunks(teacher, schedule, normalizer, teacher_steps, False, batch_size,
                              num_chunks, seed, noise=noise, device=device)
    s_chunks = rollout_chunks(student, schedule, normalizer, student_steps, student_distilled,
                              batch_size, num_chunks, seed, solver=student_solver, noise=noise,
                              device=device)
    curve = np.mean(np.abs(t_chunks - s_chunks), axis=(1, 2, 3))
    action_scale = float(np.mean(np.abs(np.diff(t_chunks, axis=2))))
    return {
        "num_chunks": int(num_chunks),
        "batch_size": int(batch_size),
        "teacher": f"ddim{teacher_steps}",
        "student": ("distilled1" if student_distilled
                    else solver_label(student_solver, student_steps)),
        "divergence_curve_rad": [float(v) for v in curve],
        "final_divergence_rad": float(curve[-1]),
        "mean_divergence_rad": float(curve.mean()),
        "teacher_tick_action_scale_rad": action_scale,
    }


def self_consistency(model, schedule: DiffusionSchedule, normalizer, num_steps: int,
                     batch_size: int = 64, num_chunks: int = 10, seed: int = 0,
                     noise_fn: NoiseFn | None = None, device="cuda") -> dict:
    """The yardstick: the same sampler rolled out twice on different noise
    streams (``seed`` and ``seed + 104729``). A student's divergence below
    this level is sampling variation."""
    a = rollout_chunks(model, schedule, normalizer, num_steps, False, batch_size, num_chunks,
                       seed, noise=_stream(noise_fn, seed, num_chunks, batch_size, model.config),
                       device=device)
    second = seed + 104729
    b = rollout_chunks(model, schedule, normalizer, num_steps, False, batch_size, num_chunks,
                       second, noise=_stream(noise_fn, second, num_chunks, batch_size,
                                             model.config),
                       device=device)
    curve = np.mean(np.abs(a - b), axis=(1, 2, 3))
    return {
        "divergence_curve_rad": [float(v) for v in curve],
        "mean_divergence_rad": float(curve.mean()),
    }
