"""Checkpoints: the port's own format, and the JAX package's, read.

A checkpoint is a directory with the JAX package's embedded-hyperparameters
contract: ``hyperparams.json`` holds the flat hyperparameter dict and the
epoch, beside the arrays in one of two formats. ``load_checkpoint`` picks
the format from the files the directory holds, never by trying one:

  state.pt       the port's: ``torch.save`` of params (the model's state
                 dict), the AdamW state dict, the EMA, the normaliser and
                 the step; ``save_checkpoint`` writes it, to a temporary
                 directory renamed into place.
  state.msgpack  the JAX package's (``soccerdiffusion_tpu/training/
                 checkpoint.py``): flax's msgpack of params, batch_stats,
                 opt_state (optax's), norm, step and, with EMA, ema_params;
                 read by ``utils/flax_msgpack.py`` (no ``msgpack`` or flax
                 package) and laid out as the port's names and tensors by
                 ``utils/jax_params.py``'s mapping, so that both formats
                 return the same dict. The JAX package's import of a
                 reference ``.pth`` (``opt_state={}``) is such a checkpoint.

A ``hyperparams.json`` marked ``"backend": "orbax"`` (the JAX package's
orbax checkpoints) raises ``ValueError``: reading it needs orbax and
tensorstore, which import jax. A directory with neither file raises
``FileNotFoundError``, one with both ``ValueError``.

Restoring into a ``TrainState`` (``train.py --checkpoint``) takes the
parameters, the EMA (seeded from the parameters where the state keeps one
and the checkpoint does not, as the JAX package does), the step and the
AdamW moments: from a JAX checkpoint, optax's ``ScaleByAdamState`` (found
by its keys ``count`` / ``mu`` / ``nu`` wherever the optimizer chain put
it) gives each parameter's ``exp_avg`` / ``exp_avg_sq`` through the same
layout transform as the parameter, and ``count`` its ``step``. An empty
optimizer state (an imported reference checkpoint, in either format)
starts fresh moments, and says so in the log; the one flat mu / nu of
``flat_optimizer`` is refused.

``load_policy_checkpoint`` decodes a checkpoint's serving point, as the
JAX function of that name does; ``build_policy`` builds a policy from a
decoded checkpoint and ``load_policy`` the one a checkpoint serves.

Under a process group every rank calls ``save_checkpoint``: a model split
over ``"model"`` (``parallel/tensor_parallel.py``) gathers its parameters,
EMA and AdamW moments to their whole shapes first (a collective), rank 0
alone writes, and the others wait for it at a barrier; the checkpoint is
the single-process one. ``load_checkpoint`` into such a model slices the
whole tensors (of either format) to the rank's share.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.parallel import comm, distributed

logger = logging.getLogger("soccerdiffusion_tpu_torch")

FORMAT = "soccerdiffusion_tpu_torch/1"
JAX_FORMAT = "soccerdiffusion_tpu/msgpack"
ADAM_KEYS = {"count", "mu", "nu"}


def save_checkpoint(path: str | Path, state, normalizer: Normalizer,
                    hyperparams: dict[str, Any], epoch: int) -> None:
    params, ema = state.model.state_dict(), state.ema
    optimizer = state.optimizer.adamw.state_dict()
    tp = getattr(state.model, "tensor_parallel", None)
    if tp is not None:
        params = {k: tp.full(k, v) for k, v in params.items()}
        ema = {k: tp.full(k, v) for k, v in ema.items()}
        optimizer = _map_moments(optimizer, state.optimizer.state_names, tp.full)
    if distributed.rank() != 0:
        comm.barrier()
        return
    write_checkpoint(path, params, optimizer, ema, normalizer, int(state.step), hyperparams,
                     epoch)
    comm.barrier()


def write_checkpoint(path: str | Path, params: dict[str, torch.Tensor], optimizer: dict,
                     ema: dict[str, torch.Tensor], normalizer: Normalizer, step: int,
                     hyperparams: dict[str, Any], epoch: int) -> None:
    """Write a checkpoint of the port's format at ``path`` (through a
    temporary directory renamed into place): ``params`` the model's state
    dict, ``optimizer`` the AdamW state dict ({} for none), ``ema`` by
    parameter name ({} for none)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({
        "format": FORMAT,
        "step": int(step),
        "params": cpu(params),
        "optimizer": optimizer,
        "ema": cpu(ema),
        "norm": {"mean": normalizer.mean.cpu(), "std": normalizer.std.cpu()},
    }, tmp / "state.pt")
    (tmp / "hyperparams.json").write_text(
        json.dumps({"hyperparams": hyperparams, "current_epoch": epoch}, indent=2))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def _map_moments(optimizer: dict, names: list[str], fn) -> dict:
    """The AdamW state dict with ``fn(name, tensor)`` applied to each
    parameter-shaped moment (``exp_avg``, ``exp_avg_sq``)."""
    state = {}
    for index, moments in optimizer["state"].items():
        name = names[int(index)]
        state[index] = {k: fn(name, v) if k != "step" else v for k, v in moments.items()}
    return {**optimizer, "state": state}


def checkpoint_format(path: str | Path) -> str:
    """``FORMAT`` for a directory holding ``state.pt``, ``JAX_FORMAT`` for one
    holding ``state.msgpack``; raises ``ValueError`` for an orbax checkpoint
    or a directory holding both, ``FileNotFoundError`` for neither."""
    path = Path(path)
    meta = path / "hyperparams.json"
    if meta.is_file() and json.loads(meta.read_text()).get("backend") == "orbax":
        raise ValueError(f"{path} is an orbax checkpoint of the JAX package: reading it needs "
                         "orbax and tensorstore, which import jax; the port reads state.pt and "
                         "the JAX package's state.msgpack")
    found = [name for name in ("state.pt", "state.msgpack") if (path / name).is_file()]
    if len(found) == 2:
        raise ValueError(f"{path} holds both state.pt and state.msgpack: which is the checkpoint?")
    if not found:
        raise FileNotFoundError(f"{path} holds no checkpoint: neither state.pt (the port's "
                                "format) nor state.msgpack (the JAX package's)")
    return FORMAT if found[0] == "state.pt" else JAX_FORMAT


def _skeleton(hyperparams: dict):
    """A policy of the hyperparameters' architecture on the meta device: the
    names and shapes a JAX checkpoint's trees are mapped onto."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy

    with torch.device("meta"):
        return DiffusionPolicy(Config.from_dict(hyperparams).model)


def _read_jax(path: Path, hyperparams: dict) -> tuple[dict[str, Any], Any]:
    """The raw fields of a JAX checkpoint in the port's layout (the optimizer
    stays optax's tree, mapped by ``_adamw_state`` on a restore), and the
    skeleton they were mapped onto."""
    from soccerdiffusion_tpu_torch.utils import flax_msgpack
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_parameters, flax_state_dict

    data = (path / "state.msgpack").read_bytes()
    raw = flax_msgpack.restore(data, str(path / "state.msgpack"))
    skeleton = _skeleton(hyperparams)
    params = flax_state_dict(skeleton, raw["params"], raw.get("batch_stats") or None)
    ema = raw.get("ema_params") or {}
    f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    return {"format": JAX_FORMAT, "step": int(np.asarray(raw["step"])), "params": params,
            "optimizer": raw.get("opt_state") or {},
            "ema": flax_parameters(skeleton, ema, "ema_params") if ema else {},
            "norm": {"mean": f32(raw["norm"]["mean"]), "std": f32(raw["norm"]["std"])}}, skeleton


def _adam_states(tree) -> list[dict]:
    """Every optax ``ScaleByAdamState`` (a dict with the keys count / mu /
    nu) in an opt_state tree, wherever its chain puts it."""
    if not isinstance(tree, dict):
        return []
    if ADAM_KEYS <= set(tree):
        return [tree]
    return [found for value in tree.values() for found in _adam_states(value)]


def _adamw_state(opt_state: dict, skeleton, optimizer, path: Path) -> dict | None:
    """The AdamW state dict of ``optimizer`` (a port ``Optimizer``) holding a
    JAX checkpoint's optax moments: mu -> exp_avg, nu -> exp_avg_sq, count ->
    each parameter's step, every moment in its parameter's torch layout.
    None for an empty opt_state (the JAX importer's)."""
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_parameters

    if not opt_state:
        return None
    adam = _adam_states(opt_state)
    if len(adam) != 1:
        raise ValueError(f"{path}: the optimizer state holds {len(adam)} Adam states (keys "
                         f"{sorted(ADAM_KEYS)}), the port's AdamW restores one")
    adam = adam[0]
    if not isinstance(adam["mu"], dict):
        raise ValueError(f"{path} was written with flat_optimizer (one flat mu / nu over the "
                         "raveled parameters), which the port does not port; resume it with "
                         "flat_optimizer: false in the JAX package, or serve it")
    mu = flax_parameters(skeleton, adam["mu"], "opt_state mu")
    nu = flax_parameters(skeleton, adam["nu"], "opt_state nu")
    count = float(np.asarray(adam["count"]))
    return {"state": {i: {"step": torch.tensor(count), "exp_avg": mu[name],
                          "exp_avg_sq": nu[name]}
                      for i, name in enumerate(optimizer.state_names)},
            "param_groups": optimizer.adamw.state_dict()["param_groups"]}


def load_checkpoint(path: str | Path, state=None) -> dict[str, Any]:
    """Returns {format, params, optimizer, ema, step, norm: Normalizer,
    hyperparams, current_epoch} of either format (``params`` the model's
    state dict, ``ema`` by parameter name; ``optimizer`` the AdamW state
    dict, or for a JAX checkpoint optax's opt_state tree); with ``state``
    (a ``TrainState``) the params, optimizer state, EMA and step are also
    restored into it, on its device."""
    path = Path(path)
    fmt = checkpoint_format(path)
    meta = json.loads((path / "hyperparams.json").read_text())
    skeleton = None
    if fmt == FORMAT:
        raw = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        if raw.get("format") != FORMAT:
            raise ValueError(f"{path}/state.pt is not a {FORMAT} checkpoint "
                             f"(format {raw.get('format')!r})")
    else:
        raw, skeleton = _read_jax(path, meta["hyperparams"])
    if state is not None:
        params, ema, optimizer = raw["params"], raw["ema"], raw["optimizer"]
        if fmt == JAX_FORMAT:
            optimizer = _adamw_state(optimizer, skeleton, state.optimizer, path)
        tp = getattr(state.model, "tensor_parallel", None)
        if tp is not None:
            params = {k: tp.local(k, v) for k, v in params.items()}
            ema = {k: tp.local(k, v) for k, v in ema.items()}
            if optimizer:
                optimizer = _map_moments(optimizer, state.optimizer.state_names, tp.local)
        state.model.load_state_dict(params)
        if optimizer:
            state.optimizer.adamw.load_state_dict(optimizer)
        else:
            logger.info(f"{path} holds no optimizer state (an imported checkpoint): the "
                        "parameters are restored, AdamW starts with fresh moments")
        device = next(state.model.parameters()).device
        if state.ema and not ema:  # EMA newly enabled: seed it from the restored params
            ema = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        state.ema = {k: v.to(device) for k, v in ema.items()}
        state.step = raw["step"]
    return {**raw, "norm": Normalizer(mean=raw["norm"]["mean"], std=raw["norm"]["std"]),
            "hyperparams": meta["hyperparams"], "current_epoch": meta["current_epoch"]}


def load_policy_checkpoint(path: str | Path, prefer_ema: bool = True
                           ) -> tuple[dict, dict[str, torch.Tensor], Normalizer, int, bool]:
    """A checkpoint for serving or evaluation: ``(hyperparams, state_dict,
    normalizer, steps, distilled)``.

    ``state_dict`` loads into a ``DiffusionPolicy`` of the hyperparameters'
    config: the EMA parameters where the checkpoint keeps an average (and
    ``prefer_ema``), else the raw ones, with the BatchNorm buffers.
    ``steps`` is the sampler's step count: ``distilled_num_steps`` for a
    few-step student (``training/distill.py --student-steps K``), 1 for a
    ``distilled_decoder`` student, else ``distill_teacher_inference_steps``
    (default 30), the count a teacher's students were distilled against.
    ``distilled`` is the ``distilled_decoder`` flag (a single forward at
    t=0)."""
    ckpt = load_checkpoint(path)
    params = ckpt["hyperparams"]
    state_dict = dict(ckpt["params"])
    if prefer_ema and ckpt["ema"]:
        state_dict.update(ckpt["ema"])
    distilled = bool(params.get("distilled_decoder", False))
    steps = int(params.get("distilled_num_steps", 0)) or (
        1 if distilled else int(params.get("distill_teacher_inference_steps", 30)))
    return params, state_dict, ckpt["norm"], steps, distilled


def build_policy(model_config, state_dict: dict[str, torch.Tensor],
                 device: str | torch.device = "cuda"):
    """A ``DiffusionPolicy`` of ``model_config`` holding ``state_dict``, on
    ``device`` (the card unless the caller asks for the CPU) in eval mode."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available "
                           "(pass --device cpu for the CPU)")
    model = DiffusionPolicy(model_config)
    model.load_state_dict(state_dict)
    return model.to(device).eval()


def load_policy(path: str | Path, device: str | torch.device = "cuda", prefer_ema: bool = True):
    """The policy a checkpoint serves, on ``device`` (the card unless the
    caller asks for the CPU) in eval mode: ``(model, normalizer, steps,
    distilled, hyperparams)`` (``load_policy_checkpoint``'s decoding)."""
    from soccerdiffusion_tpu_torch.config import Config

    hyperparams, state_dict, normalizer, steps, distilled = load_policy_checkpoint(path, prefer_ema)
    model = build_policy(Config.from_dict(hyperparams).model, state_dict, device)
    return model, normalizer, steps, distilled, hyperparams
