"""Load the JAX package's flax variables into the port's modules.

``load_jax_params(model, params, batch_stats=None)`` takes
``variables["params"]`` (and ``variables["batch_stats"]``, the BatchNorm
running statistics of the ResNets) of a
``soccerdiffusion_tpu.models.DiffusionPolicy`` as nested dicts of numpy
arrays (no jax needed) and fills the matching ``DiffusionPolicy`` of this
package. Module names mirror the flax names; flax's ``layer_i`` is the
port's ``layers.i``. Per leaf module:

  nn.Linear     kernel (in, out)     -> weight (out, in), bias (if any)
  nn.LayerNorm  scale, bias          -> weight, bias
  nn.Conv1d     kernel (ps, C, E)    -> weight (E, C, ps), bias
  nn.Conv2d     kernel (kh, kw, C, E) -> weight (E, C, kh, kw), bias (if any)
  BatchNorm     scale, bias          -> weight, bias; batch_stats mean, var
                -> the ``mean`` / ``var`` buffers
  nn.Embedding  embedding (N, E)     -> weight
  StepToken     token (1, E/2)       -> token
  ViTImageEncoder  patch_kernel (P*P*C, W), patch_bias -> the same (params of
                the image encoder itself, not of a Dense)
  WindowAttention  relative_position_bias_table ((2w-1)^2, heads) -> the same

Every leaf of both trees is used exactly once and every shape is checked: a
missing or a leftover leaf raises ``KeyError``, a wrong shape
``ValueError``. ``flax_state_dict`` makes the same mapping without filling
a model (the port's state dict of a flax checkpoint), ``flax_parameters``
for one params-shaped tree (the EMA, an AdamW moment). ``flax_init_params`` (flax's initialisers) and
``random_jax_params`` (a seeded random draw) make ``(params, batch_stats)``
of that layout, for runs without a checkpoint.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.embeddings import StepToken
from soccerdiffusion_tpu_torch.models.layers import BatchNorm
from soccerdiffusion_tpu_torch.models.swin import WindowAttention
from soccerdiffusion_tpu_torch.models.vision import ViTImageEncoder


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flatten(val, path))
        elif isinstance(val, torch.Tensor):  # a bfloat16 leaf of utils/flax_msgpack.py
            out[path] = val.float().numpy()
        else:
            out[path] = np.asarray(val)
    return out


def _flax_path(module_name: str) -> str:
    return re.sub(r"layers\.(\d+)", r"layer_\1", module_name).replace(".", "/")


# (torch attribute, flax leaf, transform of the flax array into the torch
# layout) of the params collection, and of batch_stats
_LEAVES = {
    nn.Linear: (("weight", "kernel", lambda a: a.T), ("bias", "bias", None)),
    nn.LayerNorm: (("weight", "scale", None), ("bias", "bias", None)),
    nn.Conv1d: (("weight", "kernel", lambda a: a.transpose(2, 1, 0)), ("bias", "bias", None)),
    nn.Conv2d: (("weight", "kernel", lambda a: a.transpose(3, 2, 0, 1)), ("bias", "bias", None)),
    BatchNorm: (("weight", "scale", None), ("bias", "bias", None)),
    nn.Embedding: (("weight", "embedding", None),),
    StepToken: (("token", "token", None),),
    ViTImageEncoder: (("patch_kernel", "patch_kernel", None), ("patch_bias", "patch_bias", None)),
    WindowAttention: (("relative_position_bias_table", "relative_position_bias_table", None),),
}
_STATS = {BatchNorm: (("mean", "mean", None), ("var", "var", None))}


def _leaves(mod: nn.Module, table=_LEAVES):
    """The leaves of ``mod``'s type (or a base type) in ``table`` that the
    module holds (a bias-free layer has no bias leaf), or ()."""
    leaves = next((v for k, v in table.items() if isinstance(mod, k)), ())
    return tuple(leaf for leaf in leaves if getattr(mod, leaf[0]) is not None)


def _map(model: nn.Module, tree, table, what: str) -> dict[str, torch.Tensor]:
    """The leaves of ``tree`` laid out as ``model``'s tensors of ``table``:
    {torch name: contiguous float32 CPU tensor}, every leaf used once and
    every shape checked against the model's (which may lie on the meta
    device)."""
    flat = _flatten(tree)
    out, used = {}, set()
    for name, mod in model.named_modules():
        base = _flax_path(name)
        for attr, leaf, transform in _leaves(mod, table):
            path = f"{base}/{leaf}" if base else leaf  # a leaf of the root module itself
            if path not in flat:
                raise KeyError(f"flax {what} have no leaf {path!r} for {name}.{attr}")
            arr = flat[path]
            if transform is not None:
                arr = transform(arr)
            target = getattr(mod, attr)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{path}: flax shape {flat[path].shape} does not map onto "
                                 f"{name}.{attr} of shape {tuple(target.shape)}")
            # a contiguous copy: a transposed kernel would keep numpy's
            # transposed strides, which fused AdamW refuses in a moment
            out[f"{name}.{attr}" if name else attr] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order="C"))
            used.add(path)
    leftover = sorted(set(flat) - used)
    if leftover:
        raise KeyError(f"flax {what} hold leaves the port does not use: {leftover}")
    return out


def flax_parameters(model: nn.Module, tree, what: str = "params") -> dict[str, torch.Tensor]:
    """A params-shaped flax tree (``params``, ``ema_params``, an AdamW
    moment) as {parameter name of ``model``: float32 CPU tensor}, in the
    torch layout; raises unless it fills every parameter."""
    mapped = _map(model, tree, _LEAVES, what)
    n_params = sum(1 for _ in model.parameters())
    if len(mapped) != n_params:
        raise KeyError(f"flax {what} fill {len(mapped)} of the model's {n_params} parameters")
    return mapped


def flax_state_dict(model: nn.Module, params, batch_stats=None) -> dict[str, torch.Tensor]:
    """The state dict of a model of ``model``'s architecture holding flax
    ``params`` and ``batch_stats`` (required when the model has BatchNorm
    layers): every parameter and BatchNorm statistic, float32 CPU tensors.
    ``model`` only lends the names and shapes (the meta device will do)."""
    out = flax_parameters(model, params)
    n_stats = sum(len(_leaves(m, _STATS)) for m in model.modules())
    if n_stats and batch_stats is None:
        raise KeyError(f"the model holds {n_stats} BatchNorm statistics: pass batch_stats")
    out.update(_map(model, batch_stats or {}, _STATS, "batch_stats"))
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, params, batch_stats=None) -> nn.Module:
    """Copy flax ``params`` (and ``batch_stats``, required when the model
    has BatchNorm layers) into ``model`` in place, onto the model's device
    (the parameters and statistics are float32), and return it."""
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    for name, value in flax_state_dict(model, params, batch_stats).items():
        tensors[name].copy_(value)
    return model


def _tree_node(tree: dict, module_name: str) -> dict:
    node = tree
    for part in _flax_path(module_name).split("/"):
        node = node.setdefault(part, {})
    return node


def _draw(model: nn.Module, arr_fn) -> tuple[dict, dict]:
    """(params, batch_stats) trees of ``model``'s flax layout, each leaf
    ``arr_fn(module, attr, torch shape)`` in the flax layout, float32."""
    trees: tuple[dict, dict] = ({}, {})
    for name, mod in model.named_modules():
        for tree, table in zip(trees, (_LEAVES, _STATS)):
            leaves = _leaves(mod, table)
            if leaves:
                node = _tree_node(tree, name)
                for attr, leaf, _ in leaves:
                    shape = tuple(getattr(mod, attr).shape)
                    node[leaf] = np.asarray(arr_fn(mod, attr, shape), dtype=np.float32)
    return trees


def _fan_in(mod: nn.Module, shape: tuple) -> int:
    return int(np.prod(shape[1:])) if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)) \
        else shape[0]


def _flax_kernel_shape(mod: nn.Module, shape: tuple) -> tuple:
    """The flax layout of a torch weight shape: Dense (in, out), conv (*k, in, out)."""
    if isinstance(mod, nn.Linear):
        return shape[::-1]
    return (*shape[2:][::-1], shape[1], shape[0]) if isinstance(mod, nn.Conv1d) else \
        (*shape[2:], shape[1], shape[0])


def flax_init_params(model: nn.Module, seed: int) -> tuple[dict, dict]:
    """(params, batch_stats) in the flax layout drawn from flax's default
    initialisers, the JAX package's initial variables in distribution
    (numpy float32): Dense and conv kernels LeCun-normal (normal truncated
    at 2 std, std sqrt(1 / fan_in) / 0.8796), zero biases, LayerNorm and
    BatchNorm scale 1 and bias 0, embedding rows normal with std sqrt(1 /
    E), the step token unit normal, the Swin bias tables normal truncated
    at 2 std with std 0.02; the ViT's patch kernel like a Dense kernel over
    its P*P*C inputs; the BatchNorm statistics mean 0 and var 1."""
    rng = np.random.default_rng(seed)

    def truncated(shape, std):
        a = rng.standard_normal(shape)
        while (bad := np.abs(a) > 2.0).any():
            a[bad] = rng.standard_normal(int(bad.sum()))
        return a * std

    def init(mod, attr, shape):
        if attr == "weight" and isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            return truncated(_flax_kernel_shape(mod, shape),
                             np.sqrt(1.0 / _fan_in(mod, shape)) / 0.87962566103423978)
        if attr == "patch_kernel":
            return truncated(shape, np.sqrt(1.0 / shape[0]) / 0.87962566103423978)
        if attr == "relative_position_bias_table":
            return truncated(shape, 0.02)
        if attr == "var" or (attr == "weight" and isinstance(mod, (nn.LayerNorm, BatchNorm))):
            return np.ones(shape)
        if attr.endswith("bias") or attr == "mean":
            return np.zeros(shape)
        if isinstance(mod, nn.Embedding):
            return rng.standard_normal(shape) / np.sqrt(shape[1])
        return rng.standard_normal(shape)

    return _draw(model, init)


def random_jax_params(model: nn.Module, seed: int) -> tuple[dict, dict]:
    """Seeded random (params, batch_stats) in the flax layout (numpy
    float32): LeCun-normal Dense / conv / patch kernels, small biases,
    LayerNorm and BatchNorm scales near 1, unit-normal embeddings and step
    token, Swin bias tables of std 0.02, BatchNorm statistics with mean
    near 0 and var in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(mod, attr, shape):
        if attr == "weight" and isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            return rng.normal(size=_flax_kernel_shape(mod, shape)) / np.sqrt(_fan_in(mod, shape))
        if attr == "patch_kernel":
            return rng.normal(size=shape) / np.sqrt(shape[0])
        if attr == "relative_position_bias_table":
            return 0.02 * rng.normal(size=shape)
        if attr == "weight" and isinstance(mod, (nn.LayerNorm, BatchNorm)):
            return 1.0 + 0.1 * rng.normal(size=shape)
        if attr.endswith("bias") or attr == "mean":
            return 0.1 * rng.normal(size=shape)
        if attr == "var":
            return rng.uniform(0.5, 1.5, size=shape)
        return rng.normal(size=shape)

    return _draw(model, draw)
