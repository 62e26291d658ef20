"""Meshes of ranks and the sharding rules (counterpart of
``soccerdiffusion_tpu/parallel/mesh.py``).

A mesh lays the process group's ranks out on named axes, row-major in the
order the shape names them (``{"data": 4, "model": 2}``: rank = 2 d + m). A
rank's *group over axes A* is the ranks that share its coordinates on every
other axis; ``make_mesh`` creates one ``torch.distributed`` group for each
axis and for the batch axes (``"dcn"`` x ``"data"`` on a two-level mesh), on
every rank in the same order, as ``new_group`` requires. A group's ranks in
row-major order over A are increasing global ranks, so a rank's group rank
is its row-major index over A.

The JAX mesh places an array's shards on devices under one controller; here
each rank holds its own share:

  * the batch: ``shard_batch`` gives a rank its rows of the global batch,
    over ``"data"`` (or ``"dcn"`` x ``"data"``), as
    ``tests/multihost_worker.py`` hands JAX each process's rows;
  * the parameters: ``param_placements`` says, for each parameter of a
    port model, which dimension is split over which axis, by the JAX
    rules' Megatron column / row patterns (``_TP_COLUMN`` / ``_TP_ROW``).
    The port's ``Linear`` stores its weight (out, in) where flax stores the
    kernel (in, out): a column split (flax ``P(None, "model")``) splits the
    port's dimension 0, a row split (``P("model", None)``) dimension 1.
    ``parallel/tensor_parallel.py`` applies them.

The rules and the placements are pure functions of the mesh shape and the
parameter names: they need no process group. ``use_mesh`` is the ambient
mesh (JAX's ``with mesh:``), which ``attention_impl: "ring"`` and the
synchronised BatchNorm read.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

#: the reserved mesh-axis name for the slow cross-node dimension
DCN_AXIS = "dcn"

# Megatron-style tensor parallelism for the transformer stacks: column-split
# into the axis (q / k / v projections, MLP in), row-split out of it
# (attention out_proj, MLP out). Everything else is replicated.
_TP_COLUMN = re.compile(r"(q_proj|k_proj|v_proj|linear1)$")
_TP_ROW = re.compile(r"(out_proj|linear2)$")


class Mesh:
    """Ranks laid out on named axes. ``ranks`` holds the global rank at each
    mesh position; ``rank`` is this process's. ``group(axes)`` is the
    ``torch.distributed`` group of this rank over ``axes`` (None where the
    group is this rank alone or no process group is up)."""

    def __init__(self, shape: dict[str, int], ranks: np.ndarray, rank: int):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.ranks = np.asarray(ranks).reshape([self.shape[a] for a in self.axis_names])
        self.rank = int(rank)
        where = np.argwhere(self.ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {self.shape}")
        self.coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self._groups: dict[tuple[str, ...], object] = {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        index = 0
        for a in self._axes(axes):
            index = index * self.shape[a] + self.coords[a]
        return index

    def all_group_ranks(self, axes) -> list[list[int]]:
        """Every group over ``axes``: lists of global ranks, each in
        row-major order over ``axes``."""
        axes = self._axes(axes)
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        moved = np.transpose(self.ranks, rest + order)
        return [list(map(int, g)) for g in moved.reshape(-1, self.axis_size(axes))]

    def group_ranks(self, axes) -> list[int]:
        return next(g for g in self.all_group_ranks(axes) if self.rank in g)

    def group(self, axes):
        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self._groups:
            raise KeyError(f"no process group over {axes} on this mesh (make_mesh creates one "
                           "per axis and one over the batch axes, when a process group is up)")
        return self._groups[axes]

    def create_groups(self, axes_sets) -> None:
        """Create the groups over each of ``axes_sets`` (every rank calls
        this with the same sets, in the same order)."""
        for axes in axes_sets:
            axes = self._axes(axes)
            if self.axis_size(axes) == 1 or axes in self._groups:
                continue
            mine = None
            for ranks in self.all_group_ranks(axes):
                if ranks != sorted(ranks):
                    raise AssertionError(f"group {ranks} over {axes} is not in rank order")
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = group
            self._groups[axes] = mine

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _world(world_size: int | None, rank: int | None) -> tuple[int, int, bool]:
    """(world size, rank, whether they are the process group's)."""
    up = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if up else 1
    if rank is None:
        rank = dist.get_rank() if up else 0
    live = up and world_size == dist.get_world_size() and rank == dist.get_rank()
    return int(world_size), int(rank), live


def _finish(mesh: Mesh, live: bool) -> Mesh:
    if live and mesh.size > 1:
        sets = [(a,) for a in mesh.axis_names]
        sets.append(rules_for_mesh(mesh).batch_axes())
        mesh.create_groups(sets)
    return mesh


def make_mesh(shape: dict[str, int] | None = None, world_size: int | None = None,
              rank: int | None = None) -> Mesh:
    """A mesh over the process group's ranks (or over ``world_size`` ranks as
    ``rank``, with no groups, where no process group is up). ``shape`` maps
    axis name -> size; {} or None puts every rank on ``"data"``. A
    ``"dcn"`` key asks for the two-level mesh (``make_hybrid_mesh``). The
    sizes must multiply to the world size."""
    world_size, rank, live = _world(world_size, rank)
    if not shape:
        shape = {"data": world_size}
    if DCN_AXIS in shape:
        ici = {k: v for k, v in shape.items() if k != DCN_AXIS}
        return make_hybrid_mesh(ici or None, shape[DCN_AXIS], world_size, rank)
    n = math.prod(shape.values())
    if n != world_size:
        raise ValueError(f"mesh {dict(shape)} needs {n} ranks, have {world_size}")
    return _finish(Mesh(shape, np.arange(world_size), rank), live)


def make_hybrid_mesh(ici_shape: dict[str, int] | None = None, num_slices: int | None = None,
                     world_size: int | None = None, rank: int | None = None) -> Mesh:
    """Two-level mesh ("dcn", *ici axes), dcn outermost: ranks grouped by
    node, so that every other axis's collectives stay within a node and
    only the dcn axis crosses nodes.

    A node is torchrun's block of ``LOCAL_WORLD_SIZE`` consecutive ranks
    (its global rank is node rank x local world size + local rank;
    without torchrun's environment, one node holds every rank). Where one node holds
    every rank and ``num_slices`` > 1, it simulates that many nodes as
    contiguous equal blocks, as the JAX function does for the CPU mesh."""
    world_size, rank, live = _world(world_size, rank)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if world_size % per_node:
        raise ValueError(f"{world_size} ranks are not whole nodes of {per_node}")
    groups = {n: list(range(n * per_node, (n + 1) * per_node))
              for n in range(world_size // per_node)}
    if len(groups) == 1 and num_slices and num_slices > 1:
        if world_size % num_slices:
            raise ValueError(f"{world_size} ranks do not split into {num_slices} equal slices")
        per = world_size // num_slices
        groups = {i: list(range(i * per, (i + 1) * per)) for i in range(num_slices)}
    ns = num_slices or len(groups)
    if ns != len(groups):
        raise ValueError(f"requested {ns} slices, topology has {len(groups)}")
    per_slice = world_size // ns
    ici_shape = dict(ici_shape or {"data": per_slice})
    need = math.prod(ici_shape.values())
    if need != per_slice:
        raise ValueError(f"ici_shape {ici_shape} needs {need} ranks/slice, have {per_slice}")
    ranks = np.asarray([groups[k] for k in sorted(groups)])
    return _finish(Mesh({DCN_AXIS: ns, **ici_shape}, ranks, rank), live)


@dataclass(frozen=True)
class MeshRules:
    """How parameters and the batch map onto mesh axes."""

    data_axis: str = "data"
    model_axis: str | None = None  # None: pure data parallelism (parameters replicated)
    # two-level mesh: the batch is split over "dcn" x data_axis as well
    dcn: bool = False

    def __post_init__(self):
        if self.model_axis == DCN_AXIS:
            raise ValueError(
                "model parallelism over the DCN axis is never profitable — use an ICI axis for "
                "model_axis and dcn=True for cross-slice data parallelism")

    def placement(self, name: str, shape) -> tuple[int, str] | None:
        """(dimension, axis) along which the port parameter ``name`` of
        ``shape`` is split, or None (replicated)."""
        if self.model_axis is None:
            return None
        parts = name.split(".")
        parent, leaf = (parts[-2] if len(parts) >= 2 else ""), parts[-1]
        if leaf == "weight" and len(shape) == 2:
            if _TP_COLUMN.search(parent):
                return 0, self.model_axis
            if _TP_ROW.search(parent):
                return 1, self.model_axis
        if leaf == "bias" and _TP_COLUMN.search(parent):
            return 0, self.model_axis
        return None

    def batch_axes(self) -> tuple[str, ...]:
        return (DCN_AXIS, self.data_axis) if self.dcn else (self.data_axis,)


def _axis_names(mesh) -> tuple[str, ...]:
    return mesh.axis_names if isinstance(mesh, Mesh) else tuple(mesh)


def rules_for_mesh(mesh) -> MeshRules:
    """Rules from a mesh's (or a shape dict's) axis names: "data" (or the
    last axis) carries the batch, "model" (if present) tensor parallelism,
    and a "dcn" axis extends data parallelism across nodes."""
    names = _axis_names(mesh)
    candidates = [n for n in names if n not in (DCN_AXIS, "model")]
    if "data" in candidates:
        data_axis = "data"
    elif candidates:
        data_axis = candidates[-1]
    elif DCN_AXIS in names:
        return MeshRules(data_axis=DCN_AXIS, model_axis="model" if "model" in names else None,
                         dcn=False)
    else:
        raise ValueError(f"mesh axes {names} leave no axis to shard the batch over")
    return MeshRules(data_axis=data_axis, model_axis="model" if "model" in names else None,
                     dcn=DCN_AXIS in names)


def param_placements(mesh_shape, model, rules: MeshRules | None = None
                     ) -> dict[str, tuple[int, str] | None]:
    """{parameter name: (dimension, axis) or None} for every parameter of
    ``model`` (the counterpart of ``param_shardings``)."""
    rules = rules or rules_for_mesh(mesh_shape)
    return {name: rules.placement(name, tuple(p.shape)) for name, p in model.named_parameters()}


def shard_batch(mesh: Mesh, host_batch: dict, rules: MeshRules | None = None) -> dict:
    """This rank's rows of the global host batch (numpy arrays or tensors):
    the batch split over the rules' batch axes in row-major order. Raises
    where the batch does not split evenly."""
    rules = rules or rules_for_mesh(mesh)
    axes = rules.batch_axes()
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    out = {}
    for key, value in host_batch.items():
        rows = len(value)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows ({key}) does not split over the {n} ranks "
                             f"of {axes}")
        b = rows // n
        out[key] = value[i * b:(i + 1) * b]
    return out


_AMBIENT: list[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the ambient mesh inside the block (JAX's ``with
    mesh:``). Process-wide, not per thread: the backward that autograd runs
    on its own threads (a remat recompute) sees the mesh of the step that
    built the graph, so keep the block around the backward too."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh() -> Mesh | None:
    """The mesh of the innermost ``use_mesh`` block, else None."""
    return _AMBIENT[-1] if _AMBIENT else None


def batch_group(mesh: Mesh | None):
    """(group, size, index) of this rank over the mesh's batch axes; (None,
    1, 0) without a mesh."""
    if mesh is None:
        return None, 1, 0
    axes = rules_for_mesh(mesh).batch_axes()
    return mesh.group(axes), mesh.axis_size(axes), mesh.axis_index(axes)
