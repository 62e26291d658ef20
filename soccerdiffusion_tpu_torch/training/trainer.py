"""The training step and optimizer (counterpart of
``soccerdiffusion_tpu/training/trainer.py``).

One step: normalise the target chunk, draw per-element timesteps and
noise, run forward diffusion, predict epsilon, take the MSE, backpropagate
into the float32 master parameters, clip by global norm (optional), AdamW
under optax's one-cycle cosine schedule, and update the EMA (optional).
Under ``torch.profiler`` its stages are spans on the calling thread
(``utils/profiling.py:span``): ``sd.train.draw`` (``__call__``'s draws),
``sd.train.forward`` (through the loss), ``sd.train.backward`` (the grads)
and ``sd.train.optimizer`` (gradient sync and norms, AdamW, the EMA).
The optimizer matches the JAX package: AdamW with betas 0.9 / 0.999, eps
1e-8 and decoupled weight decay (torch's AdamW update is optax's
``adamw``), its learning rate set before every update from
``lr_at_step`` at the number of updates taken so far, as optax counts.

The step runs the model in train mode, so the ResNets' BatchNorm layers
normalise with the batch statistics and update their running ones (float32
buffers: not optimised, and not in the EMA, which covers the parameters as
the JAX EMA covers ``params``).

The step draws t, the noise and, with ``modality_dropout`` > 0, the
per-sample conditioning-dropout masks (``data/pipeline.py:
dropout_modalities``, applied after ``prepare_batch`` as in the JAX step)
from an explicit ``torch.Generator``, the masks after t and the noise, so
that a run at p > 0 draws the same t and noise as one at p = 0;
``TrainStep.apply`` takes them as arguments, so tests can feed it
numpy-made values or the JAX package's draws. ``make_optimizer(...,
trainable=...)`` is the masked optimizer distillation uses: AdamW over the
parameters of the named top-level modules only, every other parameter left
as it is. ``module_lr_mults`` ({top-level module: m}, the
``image_encoder_lr_mult`` knob) scales that module's AdamW update by m (its
parameter group's learning rate is m times the schedule's, so the decoupled
weight decay scales too, as optax's ``scale`` of the whole update does);
clipping stays global, before AdamW. With ``aux_cue_weight`` > 0 the loss
adds the cue head's masked MSE against the batch's ``vision_u`` labels
(``DiffusionPolicy.forward_with_cue``), reported as ``aux_cue_loss``.
``make_optimizer(..., flat=True)`` (the ``flat_optimizer`` knob) is the same
update over one flat float32 buffer that the parameters are views of
(``training/flat_optim.py``); it clips by the flat gradient's own norm.

Data parallelism (``mesh``, ``parallel/mesh.py``): ``batch_size`` is the
global batch and each rank of the mesh's batch axes (``"data"``, or
``"dcn"`` x ``"data"``) steps on its rows of it. The step draws t, the noise
and the masks for the *global* batch from the generator (the same seed on
every rank) and keeps its rows, as the JAX step draws them for the whole
sharded batch from one key; the loss is each rank's mean, and the gradients
are averaged over the batch axes (one all-reduce of every gradient), so
that W ranks step as one process at the global batch. Clipping, the
reported ``grad_norm`` and ``loss`` (and ``aux_cue_loss``, whose masked mean
divides by the global count of valid labels) are the global ones; the
AdamW update and the EMA are then equal on every rank. The forward and
backward run under the mesh (``use_mesh``): the ResNets' BatchNorm
normalises with the global batch's statistics and ``attention_impl:
"ring"`` splits the sequence over ``"seq"``. A model split over ``"model"``
(``parallel/tensor_parallel.py``) sums the squares of its slices' gradients
over the model group for the norm.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.data.pipeline import apply_dropout_masks, draw_dropout_masks, prepare_batch
from soccerdiffusion_tpu_torch.diffusion import DiffusionSchedule, add_noise
from soccerdiffusion_tpu_torch.parallel import comm
from soccerdiffusion_tpu_torch.parallel.mesh import Mesh, batch_group, use_mesh
from soccerdiffusion_tpu_torch.utils.profiling import span


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
    and optional clipping by global norm. ``trainable`` names the top-level
    modules whose parameters it updates (None: all); the others keep their
    values, weight decay included (optax.masked in the JAX package).
    ``lr_mults`` ({top-level module: m}) gives a module's parameters a group
    whose learning rate is m times the schedule's. ``state_dict()`` holds
    the AdamW state by parameter, in ``state_names`` order."""

    flat = False

    def __init__(self, model: torch.nn.Module, lr: float, total_steps: int,
                 weight_decay: float = 1e-2, grad_clip_norm: float = 0.0,
                 trainable: tuple[str, ...] | None = None,
                 lr_mults: dict[str, float] | None = None):
        named = [(name, p) for name, p in model.named_parameters()
                 if trainable is None or name.split(".")[0] in trainable]
        self.params = [p for _, p in named]
        if not self.params:
            raise ValueError(f"no parameter of the model lies in the modules {trainable}")
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("the optimizer updates float32 master parameters")
        self.lr, self.total_steps, self.grad_clip_norm = lr, total_steps, grad_clip_norm
        self.trainable = trainable
        groups: dict[float, list[tuple[str, torch.Tensor]]] = {}
        for name, p in named:
            groups.setdefault(float((lr_mults or {}).get(name.split(".")[0], 1.0)), []).append(
                (name, p))
        # the parameter names in the order of the AdamW state's indices
        self.state_names = [name for g in groups.values() for name, _ in g]
        self.adamw = self._make_adamw(groups, lr, weight_decay)

    def _make_adamw(self, groups: dict[float, list[tuple[str, torch.Tensor]]], lr: float,
                    weight_decay: float) -> torch.optim.AdamW:
        # one multi-tensor kernel per group and update on the card (the same update)
        return adamw([{"params": [p for _, p in g], "lr_mult": m} for m, g in groups.items()],
                     lr, weight_decay, self.params[0].is_cuda)

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)

    def step(self, count: int, norm: torch.Tensor | None = None) -> None:
        """The ``count``-th update (0-based) from the parameters' grads;
        ``norm`` is their global norm where the caller has it (a
        tensor-parallel model's spans the ranks' slices)."""
        if self.grad_clip_norm > 0.0:
            clip_by_global_norm([p.grad for p in self.params], self.grad_clip_norm, norm)
        lr = lr_at_step(self.lr, self.total_steps, count)
        # a group restored from a checkpoint written before the groups had lr_mult: 1
        for group in self.adamw.param_groups:
            group["lr"] = lr * group.get("lr_mult", 1.0)
        self.adamw.step()


def adamw(groups: list[dict], lr: float, weight_decay: float, fused: bool) -> torch.optim.AdamW:
    """torch's AdamW with optax.adamw's constants: betas 0.9 / 0.999, eps
    1e-8, decoupled weight decay; fused on the card."""
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, fused=fused or None)


def make_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                   weight_decay: float = 1e-2, flat: bool = False,
                   module_lr_mults: dict[str, float] | None = None,
                   grad_clip_norm: float = 0.0,
                   trainable: tuple[str, ...] | None = None) -> Optimizer:
    """AdamW + one-cycle, clipping first when ``grad_clip_norm`` > 0; with
    ``trainable``, over the parameters of those top-level modules only; each
    module of ``module_lr_mults`` at its multiple of the learning rate.
    ``flat``: the same update on one flat buffer (``FlatOptimizer``; make it
    after the model is on its device and split over its ranks: it rebinds
    the parameters as views of the buffer)."""
    if flat:
        from soccerdiffusion_tpu_torch.training.flat_optim import FlatOptimizer

        return FlatOptimizer(model, lr, total_steps, weight_decay, grad_clip_norm, trainable,
                             module_lr_mults)
    return Optimizer(model, lr, total_steps, weight_decay, grad_clip_norm, trainable,
                     module_lr_mults)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of float32 tensors."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: scale every g by max_norm / norm
    when norm >= max_norm (no epsilon, unlike torch's clip_grad_norm_).
    ``norm`` (default: ``global_norm(grads)``) is the norm to clip by.
    Returns the norm before clipping."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def sync_gradients(params: list[torch.Tensor], group, size: int) -> None:
    """Average the parameters' gradients over ``group`` (``size`` ranks) in
    one all-reduce of their concatenation."""
    if size == 1:
        return
    grads = [p.grad for p in params]
    flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    flat.div_(size)
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(parts, grads)])


def gradient_norms(named: dict[str, torch.Tensor], tp=None) -> torch.Tensor:
    """The norm of each gradient of ``named`` (a stacked vector); a split
    parameter's is the whole gradient's, its slices' squares summed over the
    model group of ``tp`` (a ``TensorParallel``)."""
    norms = torch.stack(torch._foreach_norm(list(named.values())))
    if tp is not None and tp.size > 1:
        split = torch.tensor([n in tp.dims for n in named], device=norms.device)
        sq = comm.all_reduce_(torch.where(split, norms ** 2, torch.zeros_like(norms)), tp.group)
        norms = torch.where(split, torch.sqrt(sq), norms)
    return norms


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


def global_rows(draw: torch.Tensor, rows: int, index: int, dim: int = 0) -> torch.Tensor:
    """Rank ``index``'s ``rows`` of a draw made for the global batch."""
    return draw.narrow(dim, index * rows, rows)


class TrainStep:
    """``step(state, batch, generator) -> metrics``: one optimizer update.
    ``metrics`` holds device tensors (reading them waits for the device):
    ``loss``, ``grad_norm``, ``grad_norms_by_layer`` (per top-level module)
    and, with ``aux_cue_weight`` > 0, ``aux_cue_loss``. With ``mesh``, the
    batch is this rank's rows of the global batch (module docstring)."""

    def __init__(self, model, schedule: DiffusionSchedule, optimizer: Optimizer,
                 normalizer: Normalizer, decoder_pretraining: bool = False, ema_decay: float = 0.0,
                 modality_dropout: float = 0.0, aux_cue_weight: float = 0.0,
                 mesh: Mesh | None = None):
        self.aux_cue_weight = aux_cue_weight
        self.mesh = mesh
        self.dp_group, self.dp_size, self.dp_index = batch_group(mesh)
        self.model, self.schedule, self.optimizer = model, schedule, optimizer
        device = next(model.parameters()).device
        self.normalizer = normalizer.to(device)
        self.decoder_pretraining, self.ema_decay = decoder_pretraining, ema_decay
        self.modality_dropout = modality_dropout

    def __call__(self, state: TrainState, batch: dict[str, torch.Tensor],
                 generator: torch.Generator) -> dict:
        """Draws t (B,), the noise (B, P, J), for decoder pretraining the
        random context (B, 10, hidden) and, with modality dropout, the (5, B)
        masks from ``generator``, in that order, on its device: for the
        global batch of B = rows x the batch axes' ranks, of which the step
        keeps this rank's rows."""
        target = batch["joint_command"]
        rows, dev, i = target.shape[0], generator.device, self.dp_index
        bsz = rows * self.dp_size
        with span("sd.train.draw"):
            t = torch.randint(0, self.schedule.num_train_timesteps, (bsz,), generator=generator,
                              device=dev)
            noise = torch.randn((bsz, *target.shape[1:]), generator=generator, device=dev)
            ctx = None
            if self.decoder_pretraining:
                ctx = torch.randn((bsz, 10, self.model.config.hidden_dim), generator=generator,
                                  device=dev)
                ctx = global_rows(ctx, rows, i)
            masks = None
            if self.modality_dropout > 0.0:
                masks = global_rows(draw_dropout_masks(bsz, self.modality_dropout, generator), rows,
                                    i, 1)
            t, noise = global_rows(t, rows, i), global_rows(noise, rows, i)
        return self.apply(state, batch, t, noise, ctx, masks)

    def apply(self, state: TrainState, batch: dict[str, torch.Tensor], t: torch.Tensor,
              noise: torch.Tensor, ctx: torch.Tensor | None = None,
              masks: torch.Tensor | None = None) -> dict:
        """The step with given timesteps, noise, (decoder pretraining) random
        context tokens and (modality dropout) (5, B) dropout masks, each of
        this rank's rows."""
        with use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext():
            return self._apply(state, batch, t, noise, ctx, masks)

    def _apply(self, state, batch, t, noise, ctx, masks) -> dict:
        model, group, n = self.model, self.dp_group, self.dp_size
        # the stages, each a top-level span of a torch.profiler trace
        with span("sd.train.forward"):
            model.train()
            batch = prepare_batch(batch, keep_u8=model.config.use_images)
            if masks is not None:
                batch = apply_dropout_masks(batch, masks)
            targets = self.normalizer.normalize(batch["joint_command"].float())
            noisy = add_noise(self.schedule, targets, noise, t)
            aux = None
            if self.decoder_pretraining:
                # unconditional, against random context tokens
                pred = model.denoise(ctx, noisy, t)
            elif self.aux_cue_weight > 0.0:
                pred, cue = model.forward_with_cue(batch, noisy, t)
                label = batch["vision_u"].float()
                valid = batch.get("vision_u_valid", torch.ones_like(label)).float()
                # the masked mean over the global batch: this rank's sum over the
                # global count, times the ranks (the loss is averaged over them)
                count = comm.all_reduce_(torch.sum(valid).detach(), group)
                aux = n * torch.sum(valid * (cue - label) ** 2) / torch.clamp(count, min=1.0)
            else:
                pred = model(batch, noisy, t)
            loss = torch.mean((pred.float() - noise.float()) ** 2)
            if aux is not None:
                loss = loss + self.aux_cue_weight * aux
        with span("sd.train.backward"):
            params = dict(model.named_parameters())
            for p in params.values():
                p.grad = None
            loss.backward()
            for p in params.values():  # unused parameters get zero grads, as under jax.grad
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        with span("sd.train.optimizer"), torch.no_grad():
            sync_gradients(list(params.values()), group, n)
            norms = gradient_norms({k: p.grad for k, p in params.items()},
                                   getattr(model, "tensor_parallel", None))
            tops: dict[str, list[torch.Tensor]] = {}
            for name, norm in zip(params, norms):
                tops.setdefault(name.split(".")[0], []).append(norm)
            grad_norm = torch.linalg.vector_norm(norms)
            metrics = {
                "loss": comm.all_reduce_(loss.detach().clone(), group) / n,
                "grad_norm": grad_norm,
                "grad_norms_by_layer": {k: torch.linalg.vector_norm(torch.stack(v))
                                        for k, v in tops.items()},
            }
            if aux is not None:
                metrics["aux_cue_loss"] = comm.all_reduce_(aux.detach().clone(), group) / n
            # the flat optimizer clips by the flat gradient's norm, as JAX's flat_wrap
            # does, unless the norm spans the ranks' slices of a split model
            tp = getattr(model, "tensor_parallel", None)
            split = tp is not None and tp.size > 1
            self.optimizer.step(state.step, None if self.optimizer.flat and not split else grad_norm)
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
                    aux_cue_weight: float = 0.0, mesh: Mesh | None = None) -> TrainStep:
    """The train step. ``ema_decay > 0`` keeps ``state.ema`` (seed it with
    ``create_train_state(ema=True)``), warming the decay up as
    ``min(ema_decay, (1 + t) / (10 + t))`` at update count t. ``mesh``:
    this rank's share of a data / tensor / sequence-parallel step."""
    return TrainStep(model, schedule, optimizer, normalizer, decoder_pretraining, ema_decay,
                     modality_dropout, aux_cue_weight, mesh)
