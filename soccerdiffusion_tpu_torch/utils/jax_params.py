"""Load the JAX package's flax params into the port's modules.

``load_jax_params(model, params)`` takes ``variables["params"]`` of a
``soccerdiffusion_tpu.models.DiffusionPolicy`` as a nested dict of numpy
arrays (no jax needed) and fills the matching ``DiffusionPolicy`` of this
package. Module names mirror the flax names; flax's ``layer_i`` is the
port's ``layers.i``. Per leaf module:

  nn.Linear     kernel (in, out)     -> weight (out, in), bias
  nn.LayerNorm  scale, bias          -> weight, bias
  nn.Conv1d     kernel (ps, C, E)    -> weight (E, C, ps), bias
  nn.Embedding  embedding (N, E)     -> weight
  StepToken     token (1, E/2)       -> token
  ViTImageEncoder  patch_kernel (P*P*C, W), patch_bias -> the same (params of
                the image encoder itself, not of a Dense)

Every leaf is used exactly once and every shape is checked: a missing or a
leftover leaf raises ``KeyError``, a wrong shape ``ValueError``.
``random_jax_params`` makes a seeded tree of that layout, for runs without
a checkpoint.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.embeddings import StepToken
from soccerdiffusion_tpu_torch.models.vision import ViTImageEncoder


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _flax_path(module_name: str) -> str:
    return re.sub(r"layers\.(\d+)", r"layer_\1", module_name).replace(".", "/")


# (torch attribute, flax leaf, transform of the flax array into the torch layout)
_LEAVES = {
    nn.Linear: (("weight", "kernel", lambda a: a.T), ("bias", "bias", None)),
    nn.LayerNorm: (("weight", "scale", None), ("bias", "bias", None)),
    nn.Conv1d: (("weight", "kernel", lambda a: a.transpose(2, 1, 0)), ("bias", "bias", None)),
    nn.Embedding: (("weight", "embedding", None),),
    StepToken: (("token", "token", None),),
    ViTImageEncoder: (("patch_kernel", "patch_kernel", None), ("patch_bias", "patch_bias", None)),
}


def _leaves(mod: nn.Module):
    """The leaf table of ``mod``'s type (or a base type), or None."""
    return next((v for k, v in _LEAVES.items() if isinstance(mod, k)), None)


@torch.no_grad()
def load_jax_params(model: nn.Module, params) -> nn.Module:
    """Copy flax ``params`` into ``model`` in place (onto the model's
    device; the parameters are float32) and return it."""
    flat = _flatten(params)
    used = set()
    filled = 0
    for name, mod in model.named_modules():
        leaves = _leaves(mod)
        if leaves is None:
            continue
        base = _flax_path(name)
        for attr, leaf, transform in leaves:
            path = f"{base}/{leaf}" if base else leaf  # a leaf of the root module itself
            if path not in flat:
                raise KeyError(f"flax params have no leaf {path!r} for {name}.{attr}")
            arr = flat[path]
            if transform is not None:
                arr = transform(arr)
            target = getattr(mod, attr)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{path}: flax shape {flat[path].shape} does not map onto "
                                 f"{name}.{attr} of shape {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
            used.add(path)
            filled += 1
    n_params = sum(1 for _ in model.parameters())
    if filled != n_params:
        raise KeyError(f"filled {filled} of the model's {n_params} parameters")
    leftover = sorted(set(flat) - used)
    if leftover:
        raise KeyError(f"flax params hold leaves the port does not use: {leftover}")
    return model


def _tree_node(tree: dict, module_name: str) -> dict:
    node = tree
    for part in _flax_path(module_name).split("/"):
        node = node.setdefault(part, {})
    return node


def flax_init_params(model: nn.Module, seed: int) -> dict:
    """A flax-layout tree drawn from flax's default initialisers, the JAX
    package's initial parameters in distribution (numpy float32): Dense and
    conv kernels LeCun-normal (normal truncated at 2 std, std
    sqrt(1 / fan_in) / 0.8796), zero biases, LayerNorm scale 1 and bias 0,
    embedding rows normal with std sqrt(1 / E), the step token unit normal;
    the ViT's patch kernel like a Dense kernel over its P*P*C inputs."""
    rng = np.random.default_rng(seed)

    def lecun(shape, fan_in):
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        a = rng.standard_normal(shape)
        while (bad := np.abs(a) > 2.0).any():
            a[bad] = rng.standard_normal(int(bad.sum()))
        return a * std

    tree: dict = {}
    for name, mod in model.named_modules():
        leaves = _leaves(mod)
        if leaves is None:
            continue
        node = _tree_node(tree, name)
        for attr, leaf, _ in leaves:
            shape = tuple(getattr(mod, attr).shape)
            if isinstance(mod, nn.Linear) and attr == "weight":
                arr = lecun(shape[::-1], shape[1])
            elif isinstance(mod, nn.Conv1d) and attr == "weight":
                arr = lecun(shape[::-1], shape[1] * shape[2])
            elif attr == "patch_kernel":
                arr = lecun(shape, shape[0])
            elif isinstance(mod, nn.LayerNorm) and attr == "weight":
                arr = np.ones(shape)
            elif attr.endswith("bias"):
                arr = np.zeros(shape)
            elif isinstance(mod, nn.Embedding):
                arr = rng.standard_normal(shape) / np.sqrt(shape[1])
            else:
                arr = rng.standard_normal(shape)
            node[leaf] = arr.astype(np.float32)
    return tree


def random_jax_params(model: nn.Module, seed: int) -> dict:
    """Seeded random flax-layout params for ``model`` (numpy float32):
    LeCun-normal Dense / conv / patch kernels, small biases, LayerNorm scales
    near 1, unit-normal embeddings and step token."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name, mod in model.named_modules():
        leaves = _leaves(mod)
        if leaves is None:
            continue
        node = _tree_node(tree, name)
        for attr, leaf, _ in leaves:
            shape = tuple(getattr(mod, attr).shape)
            if isinstance(mod, nn.Linear) and attr == "weight":
                arr = rng.normal(size=shape[::-1]) / np.sqrt(shape[1])
            elif isinstance(mod, nn.Conv1d) and attr == "weight":
                arr = rng.normal(size=shape[::-1]) / np.sqrt(shape[1] * shape[2])
            elif attr == "patch_kernel":
                arr = rng.normal(size=shape) / np.sqrt(shape[0])
            elif isinstance(mod, nn.LayerNorm) and attr == "weight":
                arr = 1.0 + 0.1 * rng.normal(size=shape)
            elif attr.endswith("bias"):
                arr = 0.1 * rng.normal(size=shape)
            else:
                arr = rng.normal(size=shape)
            node[leaf] = arr.astype(np.float32)
    return tree
