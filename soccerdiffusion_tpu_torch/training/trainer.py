"""The training step and optimizer (counterpart of
``soccerdiffusion_tpu/training/trainer.py``).

One step: normalise the target chunk, draw per-element timesteps and
noise, run forward diffusion, predict epsilon, take the MSE, backpropagate
into the float32 master parameters, clip by global norm (optional), AdamW
under optax's one-cycle cosine schedule, and update the EMA (optional).
The optimizer matches the JAX package: AdamW with betas 0.9 / 0.999, eps
1e-8 and decoupled weight decay (torch's AdamW update is optax's
``adamw``), its learning rate set before every update from
``lr_at_step`` at the number of updates taken so far, as optax counts.

The step runs the model in train mode, so the ResNets' BatchNorm layers
normalise with the batch statistics and update their running ones (float32
buffers: not optimised, and not in the EMA, which covers the parameters as
the JAX EMA covers ``params``).

The step draws t and the noise from an explicit ``torch.Generator``;
``TrainStep.apply`` takes them as arguments, so tests can feed it
numpy-made values. ``modality_dropout``, ``aux_cue_weight``,
``flat_optimizer`` and ``image_encoder_lr_mult`` are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.data.pipeline import prepare_batch
from soccerdiffusion_tpu_torch.diffusion import DiffusionSchedule, add_noise

_SEE = "not ported yet (see ROADMAP.md)"


def lr_at_step(lr: float, total_steps: int, step: int) -> float:
    """optax.cosine_onecycle_schedule(transition_steps=total_steps,
    peak_value=lr, pct_start=0.3, div_factor=25, final_div_factor=1e4) at
    ``step``: cosine from lr/25 up to lr over the first int(0.3 total)
    steps, cosine down to lr/2.5e5 by ``total_steps``, held there after.

    (torch's OneCycleLR differs: it ends the warm-up one step earlier and
    raises past total_steps.) Where total_steps < 4 the warm-up interval
    is empty and optax returns NaN (an empty interval's 0/0 enters its
    sum); here the empty interval is skipped, which agrees with optax
    wherever optax is finite."""
    warm, total = int(0.3 * total_steps), int(total_steps)
    start, peak, final = np.cumprod([lr / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    if step >= total:
        return float(final)
    lo, hi, a, b = (0, warm, start, peak) if step < warm else (warm, total, peak, final)
    pct = (step - lo) / (hi - lo)
    return float(b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0))


class Optimizer:
    """AdamW over a model's float32 parameters with the one-cycle schedule
    and optional clipping by global norm."""

    def __init__(self, model: torch.nn.Module, lr: float, total_steps: int,
                 weight_decay: float = 1e-2, grad_clip_norm: float = 0.0):
        self.params = [p for p in model.parameters()]
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("the optimizer updates float32 master parameters")
        self.lr, self.total_steps, self.grad_clip_norm = lr, total_steps, grad_clip_norm
        # one multi-tensor kernel per update on the card (the same update)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay,
                                       fused=self.params[0].is_cuda or None)

    def step(self, count: int) -> None:
        """The ``count``-th update (0-based) from the parameters' grads."""
        if self.grad_clip_norm > 0.0:
            clip_by_global_norm([p.grad for p in self.params], self.grad_clip_norm)
        for group in self.adamw.param_groups:
            group["lr"] = lr_at_step(self.lr, self.total_steps, count)
        self.adamw.step()


def make_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                   weight_decay: float = 1e-2, flat: bool = False,
                   module_lr_mults: dict[str, float] | None = None,
                   grad_clip_norm: float = 0.0) -> Optimizer:
    """AdamW + one-cycle, clipping first when ``grad_clip_norm`` > 0."""
    if flat:
        raise NotImplementedError(f"flat_optimizer is {_SEE}")
    if any(m != 1.0 for m in (module_lr_mults or {}).values()):
        raise NotImplementedError(f"per-module learning-rate multipliers are {_SEE}")
    return Optimizer(model, lr, total_steps, weight_decay, grad_clip_norm)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of float32 tensors."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: scale every g by max_norm / norm
    when norm >= max_norm (no epsilon, unlike torch's clip_grad_norm_).
    Returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    # exponential moving average of the parameters by name ({} = disabled)
    ema: dict[str, torch.Tensor] = field(default_factory=dict)


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, ema: bool = False) -> TrainState:
    """``ema=True`` seeds the average with copies of the initial parameters."""
    return TrainState(model=model, optimizer=optimizer, step=0,
                      ema={n: p.detach().clone() for n, p in model.named_parameters()} if ema else {})


class TrainStep:
    """``step(state, batch, generator) -> metrics``: one optimizer update.
    ``metrics`` holds device tensors (reading them waits for the device):
    ``loss``, ``grad_norm`` and ``grad_norms_by_layer`` (per top-level module)."""

    def __init__(self, model, schedule: DiffusionSchedule, optimizer: Optimizer,
                 normalizer: Normalizer, decoder_pretraining: bool = False, ema_decay: float = 0.0,
                 modality_dropout: float = 0.0, aux_cue_weight: float = 0.0):
        if modality_dropout > 0.0:
            raise NotImplementedError(f"modality_dropout is {_SEE}")
        if aux_cue_weight > 0.0:
            raise NotImplementedError(f"aux_cue_weight is {_SEE}")
        self.model, self.schedule, self.optimizer = model, schedule, optimizer
        device = next(model.parameters()).device
        self.normalizer = normalizer.to(device)
        self.decoder_pretraining, self.ema_decay = decoder_pretraining, ema_decay

    def __call__(self, state: TrainState, batch: dict[str, torch.Tensor],
                 generator: torch.Generator) -> dict:
        """Draws t (B,), the noise (B, P, J) and, for decoder pretraining, the
        random context (B, 10, hidden) from ``generator``, on its device."""
        target = batch["joint_command"]
        bsz, dev = target.shape[0], generator.device
        t = torch.randint(0, self.schedule.num_train_timesteps, (bsz,), generator=generator,
                          device=dev)
        noise = torch.randn(target.shape, generator=generator, device=dev)
        ctx = None
        if self.decoder_pretraining:
            ctx = torch.randn((bsz, 10, self.model.config.hidden_dim), generator=generator, device=dev)
        return self.apply(state, batch, t, noise, ctx)

    def apply(self, state: TrainState, batch: dict[str, torch.Tensor], t: torch.Tensor,
              noise: torch.Tensor, ctx: torch.Tensor | None = None) -> dict:
        """The step with given timesteps, noise and (decoder pretraining)
        random context tokens."""
        model = self.model
        model.train()
        batch = prepare_batch(batch, keep_u8=model.config.use_images)
        targets = self.normalizer.normalize(batch["joint_command"].float())
        noisy = add_noise(self.schedule, targets, noise, t)
        if self.decoder_pretraining:
            pred = model.denoise(ctx, noisy, t)  # unconditional, against random context tokens
        else:
            pred = model(batch, noisy, t)
        loss = torch.mean((pred.float() - noise.float()) ** 2)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss.backward()
        for p in params.values():  # unused parameters get zero grads, as under jax.grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            norms = torch._foreach_norm([p.grad for p in params.values()])
            tops: dict[str, list[torch.Tensor]] = {}
            for name, n in zip(params, norms):
                tops.setdefault(name.split(".")[0], []).append(n)
            metrics = {
                "loss": loss.detach(),
                "grad_norm": torch.linalg.vector_norm(torch.stack(norms)),
                "grad_norms_by_layer": {k: torch.linalg.vector_norm(torch.stack(v))
                                        for k, v in tops.items()},
            }
            self.optimizer.step(state.step)
            state.step += 1
            if self.ema_decay > 0.0:
                step = float(state.step)
                d = min(self.ema_decay, (1.0 + step) / (10.0 + step))
                ema = [state.ema[name] for name in params]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, list(params.values()), alpha=1.0 - d)
        return metrics


def make_train_step(model, schedule: DiffusionSchedule, optimizer: Optimizer,
                    normalizer: Normalizer, decoder_pretraining: bool = False,
                    ema_decay: float = 0.0, modality_dropout: float = 0.0,
                    aux_cue_weight: float = 0.0) -> TrainStep:
    """The train step. ``ema_decay > 0`` keeps ``state.ema`` (seed it with
    ``create_train_state(ema=True)``), warming the decay up as
    ``min(ema_decay, (1 + t) / (10 + t))`` at update count t."""
    return TrainStep(model, schedule, optimizer, normalizer, decoder_pretraining, ema_decay,
                     modality_dropout, aux_cue_weight)
