"""Action-chunk sampling, the serving side's denoising path (counterpart of
``soccerdiffusion_tpu/inference/sampler.py``).

Encode the context once, then run either the iterative sampler (DDIM or
DPM-Solver++(2M) against the context's cross-attention K/V, projected once)
or the distilled student's single forward at t=0, then denormalise. With a
guidance scale w != 1 each step denoises the conditional context and the
context with ``guidance_null``'s modalities nulled in one doubled-batch pass
and combines them as eps_u + w (eps_c - eps_u) (classifier-free guidance;
meaningful on a checkpoint trained with ``modality_dropout`` > 0). The
model runs in eval mode, without autograd; a plain Python loop over the
steps replaces the JAX package's jitted scan.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable

import torch

from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.data.pipeline import inactive_guidance_modalities, null_modalities
from soccerdiffusion_tpu_torch.diffusion import DiffusionSchedule, parse_solver, solver_sample

logger = logging.getLogger("soccerdiffusion_tpu_torch")


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """``model`` in eval mode inside the block, its own mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def check_guidance(model_config, guidance_scale: float, guidance_null) -> None:
    """Where ``guidance_scale`` asks for guidance: validate the modality
    names (here, not at the first chunk) and warn where the config never
    conditions on one of them (the doubled batch then buys an unguided
    sample)."""
    if guidance_scale == 1.0:
        return
    null_modalities({}, guidance_null)
    inactive = inactive_guidance_modalities(model_config, guidance_null)
    if inactive:
        logger.warning(f"guidance over {inactive} is a no-op: the model config does not "
                       f"condition on {'/'.join(inactive)} (use_images/use_gamestate off); the "
                       "doubled-batch CFG cost buys an unguided sample")


def guided_denoise_fn(model, context_kv: list, bsz: int, guidance_scale: float):
    """``denoise_fn(x, t)`` over K/V projected from the conditional and the
    null context stacked along the batch (2 B): one doubled-batch pass a
    step, eps_u + w (eps_c - eps_u)."""

    def denoise_fn(x, t):
        steps = torch.full((2 * bsz,), t, dtype=torch.int64, device=x.device)
        eps2 = model.denoise_with_kv(context_kv, torch.cat([x, x], dim=0), steps)
        return eps2[bsz:] + guidance_scale * (eps2[:bsz] - eps2[bsz:])

    return denoise_fn


def make_chunk_sampler(model, schedule: DiffusionSchedule, normalizer: Normalizer,
                       num_inference_steps: int = 30, distilled: bool = False,
                       solver: str = "ddim", guidance_scale: float = 1.0,
                       guidance_null: tuple[str, ...] = ("image",)) -> Callable:
    """Returns ``sample_fn(batch, noise) -> (B, pred_len, J)`` action chunks in
    the [0, 2 pi) joint domain (denormalised), ``noise`` (B, pred_len, J)
    the start of the reverse process, on the model's device.

    ``solver``: "ddim" or "dpmpp". ``distilled``: the student's single
    forward at t=0 (no guidance: its output is not a score)."""
    parse_solver(solver)
    guided = guidance_scale != 1.0
    if guided and distilled:
        raise ValueError("classifier-free guidance requires an iterative sampler; the distilled "
                         "single forward is not a score prediction")
    check_guidance(model.config, guidance_scale, guidance_null)
    device = next(model.parameters()).device
    normalizer = normalizer.to(device)

    @torch.no_grad()
    def sample_fn(batch: dict, noise: torch.Tensor) -> torch.Tensor:
        with eval_mode(model):
            context = model.encode_context(batch)
            bsz = context.shape[0]
            if guided:
                ctx_u = model.encode_context(null_modalities(batch, guidance_null))
                context = torch.cat([context, ctx_u], dim=0)
            noise = noise.to(device, torch.float32)
            if distilled:
                traj = model.denoise(context, noise,
                                     torch.zeros((bsz,), dtype=torch.int64, device=device))
            else:
                context_kv = model.precompute_context_kv(context)
                if guided:
                    denoise_fn = guided_denoise_fn(model, context_kv, bsz, guidance_scale)
                else:
                    def denoise_fn(x, t):
                        steps = torch.full((bsz,), t, dtype=torch.int64, device=device)
                        return model.denoise_with_kv(context_kv, x, steps)
                traj = solver_sample(schedule, denoise_fn, noise, num_inference_steps,
                                     solver=solver)
            return normalizer.denormalize(traj)

    return sample_fn
