"""Checkpoints of the port, written with ``torch.save``, with the JAX
package's embedded-hyperparameters contract: a directory holding

  <path>/state.pt          params, optimizer state, EMA, normaliser, step
  <path>/hyperparams.json  the flat hyperparameter dict and the epoch

written to a temporary directory and renamed into place. The JAX package's
msgpack checkpoints are a different format; a reader for them is not
ported yet (see ROADMAP.md). ``load_policy_checkpoint`` decodes a
checkpoint's serving point, as the JAX function of that name does;
``build_policy`` builds a policy from a decoded checkpoint and
``load_policy`` the one a checkpoint serves.

Under a process group every rank calls ``save_checkpoint``: a model split
over ``"model"`` (``parallel/tensor_parallel.py``) gathers its parameters,
EMA and AdamW moments to their whole shapes first (a collective), rank 0
alone writes, and the others wait for it at a barrier; the checkpoint is
the single-process one. ``load_checkpoint`` into such a model slices the
whole tensors to the rank's share.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import torch

from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.parallel import comm, distributed

FORMAT = "soccerdiffusion_tpu_torch/1"


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
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({
        "format": FORMAT,
        "step": int(state.step),
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
    comm.barrier()


def _map_moments(optimizer: dict, names: list[str], fn) -> dict:
    """The AdamW state dict with ``fn(name, tensor)`` applied to each
    parameter-shaped moment (``exp_avg``, ``exp_avg_sq``)."""
    state = {}
    for index, moments in optimizer["state"].items():
        name = names[int(index)]
        state[index] = {k: fn(name, v) if k != "step" else v for k, v in moments.items()}
    return {**optimizer, "state": state}


def load_checkpoint(path: str | Path, state=None) -> dict[str, Any]:
    """Returns {params, optimizer, ema, step, norm: Normalizer, hyperparams,
    current_epoch}; with ``state`` (a ``TrainState``) the params, optimizer
    state, EMA and step are also restored into it, on its device."""
    path = Path(path)
    raw = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    if raw.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    meta = json.loads((path / "hyperparams.json").read_text())
    if state is not None:
        params, ema, optimizer = raw["params"], raw["ema"], raw["optimizer"]
        tp = getattr(state.model, "tensor_parallel", None)
        if tp is not None:
            params = {k: tp.local(k, v) for k, v in params.items()}
            ema = {k: tp.local(k, v) for k, v in ema.items()}
            optimizer = _map_moments(optimizer, state.optimizer.state_names, tp.local)
        state.model.load_state_dict(params)
        state.optimizer.adamw.load_state_dict(optimizer)
        device = next(state.model.parameters()).device
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
