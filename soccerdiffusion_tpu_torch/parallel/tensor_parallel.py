"""Tensor parallelism over the mesh's ``"model"`` axis: the Megatron column /
row splits that the JAX package expresses as parameter shardings
(``MeshRules.placement``), made explicit for one process per rank.

``shard_model`` replaces each split ``Linear`` of a model by its rank's
slice:

  * ``ColumnParallelLinear`` (q / k / v projections, the MLP's first
    layer): the rank's rows of the (out, in) weight and of the bias; the
    input passes ``copy_to_group`` (identity forward, the gradient summed
    over the model group backward);
  * ``RowParallelLinear`` (out_proj, the MLP's second layer): the rank's
    columns of the weight, the bias whole; the partial products are summed
    over the model group (``reduce_from_group``: identity backward), in
    float32, then the bias is added.

A split attention layer keeps its rank's H/n heads. A layer that runs a
fused kernel reads its weights through ``Linear.full_weight`` /
``full_bias``, which here all-gather the slices over the model group (as
GSPMD gathers before a Pallas call); the gather's backward is the rank's
slice of the weight gradient. Every rank of the model group computes the
replicated activations alike, so the gradients of replicated parameters are
equal over it and are averaged over the batch axes only, like the slices'.

``model.tensor_parallel`` (a ``TensorParallel``) records the split:
``full`` gathers a parameter-shaped tensor (a parameter, its EMA or an
optimizer moment) for a checkpoint, ``local`` slices a full one on load.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.models.attention import MultiHeadAttention
from soccerdiffusion_tpu_torch.models.layers import Linear
from soccerdiffusion_tpu_torch.parallel import comm
from soccerdiffusion_tpu_torch.parallel.mesh import Mesh, MeshRules, param_placements, rules_for_mesh


@dataclass
class TensorParallel:
    group: object
    size: int
    index: int
    dims: dict[str, int]  # split parameter name -> the dimension split

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A parameter-shaped tensor of this rank gathered to the whole
        parameter's shape (collective over the model group)."""
        dim = self.dims.get(name)
        return t if dim is None else comm.all_gather(t, self.group, dim)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole parameter-shaped tensor."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        step = t.shape[dim] // self.size
        return t.narrow(dim, self.index * step, step).contiguous()


class ColumnParallelLinear(Linear):
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(comm.copy_to_group(x, self.tp_group))

    def full_weight(self) -> torch.Tensor:
        return comm.gather_from_group(self.weight, self.tp_group, 0)

    def full_bias(self) -> torch.Tensor | None:
        return None if self.bias is None else comm.gather_from_group(self.bias, self.tp_group, 0)


class RowParallelLinear(Linear):
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = comm.reduce_from_group(F.linear(x.float(), self.weight.float()), self.tp_group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)

    def full_weight(self) -> torch.Tensor:
        return comm.gather_from_group(self.weight, self.tp_group, 1)


def _split_linear(lin: Linear, cls, dim: int, tp: TensorParallel) -> Linear:
    out_f, in_f = lin.weight.shape
    shape = (out_f // tp.size, in_f) if dim == 0 else (out_f, in_f // tp.size)
    new = cls(shape[1], shape[0], bias=lin.bias is not None,
              device=lin.weight.device, dtype=lin.weight.dtype)
    new.tp_group = tp.group
    with torch.no_grad():
        new.weight.copy_(lin.weight.narrow(dim, tp.index * shape[dim], shape[dim]))
        if lin.bias is not None:
            b = lin.bias if dim == 1 else lin.bias.narrow(0, tp.index * shape[0], shape[0])
            new.bias.copy_(b)
    return new


def shard_model(model: nn.Module, mesh: Mesh, rules: MeshRules | None = None) -> nn.Module:
    """Split ``model``'s parameters over the rules' model axis, in place
    (nothing where the mesh has no model axis of size > 1). The model holds
    the whole parameters when it is called: build and load it first."""
    rules = rules or rules_for_mesh(mesh)
    axis = rules.model_axis
    if axis is None or mesh.axis_size(axis) == 1:
        return model
    placements = param_placements(mesh.shape, model, rules)
    tp = TensorParallel(mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis),
                        {name: p[0] for name, p in placements.items() if p is not None})
    params = dict(model.named_parameters())
    for name, dim in tp.dims.items():
        if params[name].shape[dim] % tp.size:
            raise ValueError(f"{name} of shape {tuple(params[name].shape)} does not split over "
                             f"the {tp.size} ranks of {axis!r} along dimension {dim}")
    for mod_name, mod in list(model.named_modules()):
        if isinstance(mod, MultiHeadAttention) and f"{mod_name}.q_proj.weight" in tp.dims:
            if mod.num_heads % tp.size:
                raise ValueError(f"{mod_name} has {mod.num_heads} heads, which do not split over "
                                 f"the {tp.size} ranks of {axis!r}")
            mod.num_heads //= tp.size
        for child_name, child in list(mod.named_children()):
            full = f"{mod_name}.{child_name}" if mod_name else child_name
            dim = tp.dims.get(f"{full}.weight")
            if isinstance(child, Linear) and dim is not None:
                cls = ColumnParallelLinear if dim == 0 else RowParallelLinear
                setattr(mod, child_name, _split_linear(child, cls, dim, tp))
    model.tensor_parallel = tp
    return model
