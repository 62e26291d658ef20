"""The port's one communication helper: every collective of ``parallel/``,
the trainer and the rollout engine goes through these functions.

``torch.distributed``'s gloo backend runs its collectives and point-to-point
transfers on CPU tensors only. Where a group's backend is gloo and a tensor
lies on the card (two ranks sharing one card, which NCCL refuses), the
helper stages the transfer through a host copy: the tensor is copied to the
host, communicated there, and the result copied back to the tensor's
device. Over NCCL (one rank a card) the device tensors go as they are; on
the CPU nothing is copied. A group of one rank (``None``) makes every
function the identity.

The autograd functions are the collectives' differentiable forms:

  * ``all_reduce_sum``: sum forward, sum backward (the sums of a statistic
    that every rank's loss reads: synchronised BatchNorm);
  * ``copy_to_group``: identity forward, sum backward (before a
    column-split product of tensor parallelism);
  * ``reduce_from_group``: sum forward, identity backward (after a
    row-split product);
  * ``gather_from_group``: concatenation of every rank's part forward, the
    rank's own slice of the gradient backward (the gradient of a gathered
    tensor that every rank of the group reads alike is the same on each,
    so it is sliced, not summed: ``torch.distributed.nn.functional
    .all_gather`` would sum it and scale it by the group's size);
  * ``slice_to_group``: the rank's slice forward, the gathered gradient
    backward (the inverse pair).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a transfer of ``t`` over ``group`` goes through a host copy."""
    return t.device.type != "cpu" and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) concatenated along ``dim`` in
    group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    host = _staged(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def ring_shift(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each rank sends ``tensors`` to the next rank of ``group`` (group rank
    i + 1 mod n) and returns those of the previous one, in one batch of
    point-to-point transfers."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    i = group_rank(group)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    sends = [t.detach().contiguous() for t in tensors]
    host = any(_staged(t, group) for t in sends)
    if host:
        sends = [t.cpu() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)] if host else recvs


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world where None) when a
    process group is up."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)


def _own_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not split over {n} ranks")
    step = t.shape[dim] // n
    return t.narrow(dim, group_rank(group) * step, step).contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


class _SliceToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherFromGroup.apply(x, group, dim)


def slice_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _SliceToGroup.apply(x, group, dim)
