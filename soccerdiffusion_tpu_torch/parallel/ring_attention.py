"""Ring attention and head-sharded attention over a mesh axis (counterpart of
``soccerdiffusion_tpu/parallel/ring_attention.py``).

Exact attention with the sequence split over the ranks of a mesh axis: each
rank keeps its S/n slice of the queries and of the keys / values, passes
its K/V block to the next rank of the ring n - 1 times and merges each
block's partial result with the streaming-softmax rescale (the JAX
package's ``ring_attention_sharded``). No causal mask: the policy attends
bidirectionally. Layouts are the port's (B, S, H, D).

The model's q / k / v arrive replicated on every rank of the axis (the port
holds the whole sequence on each rank, as the JAX model's activations are
outside the ``shard_map``): ``ring_self_attention`` takes the rank's slice,
runs the ring and all-gathers the output along the sequence. Every rank of
the axis computes the same loss, so the gather's backward is the rank's
slice of the output gradient, and the slice's backward all-gathers the
slices' gradients (``parallel/comm.py``): the parameters' gradients come out
equal on every rank of the axis and are not summed over it. The ring's own
backward (``_RingAttention.backward``) rotates K/V again and sends each
block's dK / dV around with it, so that after n steps each rank holds the
whole gradient of its own block.

``head_sharded_attention`` is the head-split form (each rank its H/n heads
over the whole sequence, any q / kv lengths), with plain attention and an
all-gather on the heads. ``auto_ring_attention`` is ``attention_impl:
"ring"``: it reads the ambient mesh (``parallel/mesh.use_mesh``) and picks
the form the call's shapes admit, with JAX's four cases. The JAX package
computes these with plain einsums, not a Pallas kernel; so does the port.
"""

from __future__ import annotations

import math

import torch

from soccerdiffusion_tpu_torch.parallel import comm
from soccerdiffusion_tpu_torch.parallel.mesh import Mesh, ambient_mesh, rules_for_mesh

RING_AXIS = "seq"  # the mesh axis the ring rotates over


def _scores(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _block_attention(q, k, v, scale):
    """Unnormalised block attention for the streaming softmax: (acc (B, Q,
    H, D) float32, m = rowmax (B, H, Q), l = sum exp(s - m) (B, H, Q))."""
    s = _scores(q, k, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(dim=-1)


class _RingAttention(torch.autograd.Function):
    """Ring attention over the local slices q, k, v (B, S/n, H, D) of the
    ranks of ``group``."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        scale = 1.0 / math.sqrt(q.shape[-1])
        acc, m, l = _block_attention(q, k, v, scale)
        kc, vc = k, v
        for _ in range(comm.group_size(group) - 1):
            kc, vc = comm.ring_shift([kc, vc], group)
            acc_b, m_b, l_b = _block_attention(q, kc, vc, scale)
            m_new = torch.maximum(m, m_b)
            c_old, c_new = torch.exp(m - m_new), torch.exp(m_b - m_new)
            acc = (acc * c_old.transpose(1, 2)[..., None]
                   + acc_b * c_new.transpose(1, 2)[..., None])
            l = l * c_old + l_b * c_new
            m = m_new
        out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale, n = ctx.group, ctx.scale, comm.group_size(ctx.group)
        do = dout.float()
        delta = torch.einsum("bqhd,bqhd->bhq", do, out.float())  # (B, H, Q)
        dq = torch.zeros_like(q, dtype=torch.float32)
        kc, vc = k, v
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        for step in range(n):
            p = torch.exp(_scores(q, kc, scale) - lse[..., None])  # (B, H, Q, K)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vc.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc.float())
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
            # the block and its gradient so far travel on together; after
            # the last step one more shift brings each block's gradient home
            if step < n - 1:
                kc, vc, dk, dv = comm.ring_shift([kc, vc, dk, dv], group)
            else:
                dk, dv = comm.ring_shift([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention_sharded(q, k, v, group) -> torch.Tensor:
    """Ring attention over the ranks of ``group`` on this rank's slices
    (B, S/n, H, D); differentiable."""
    if comm.group_size(group) == 1:
        from soccerdiffusion_tpu_torch.models.attention import plain_attention

        return plain_attention(q, k, v)
    return _RingAttention.apply(q, k, v, group)


def ring_self_attention(q, k, v, mesh: Mesh, axis: str = RING_AXIS) -> torch.Tensor:
    """Self-attention of replicated q / k / v (B, S, H, D) with the sequence
    split over ``axis`` (S divisible by its size); the result is
    replicated."""
    group = mesh.group(axis)
    q, k, v = (comm.slice_to_group(x, group, 1) for x in (q, k, v))
    return comm.gather_from_group(ring_attention_sharded(q, k, v, group), group, 1)


def head_sharded_attention(q, k, v, mesh: Mesh, axis: str = RING_AXIS) -> torch.Tensor:
    """Attention of replicated q / k / v with the heads split over ``axis``
    (H divisible by its size): any q / kv lengths."""
    from soccerdiffusion_tpu_torch.models.attention import plain_attention

    group = mesh.group(axis)
    q, k, v = (comm.slice_to_group(x, group, 2) for x in (q, k, v))
    return comm.gather_from_group(plain_attention(q, k, v), group, 2)


def auto_ring_attention(q, k, v) -> torch.Tensor:
    """The backend of ``attention_impl: "ring"`` over the ambient mesh's
    ``seq`` axis:

      * no mesh in scope, no ``seq`` axis or one of size 1 -> plain attention
      * self-attention with S divisible by the axis -> ring attention
      * otherwise, heads divisible by the axis -> head-sharded attention
      * else -> plain attention (the shapes admit no exact split)
    """
    from soccerdiffusion_tpu_torch.models.attention import plain_attention

    mesh = ambient_mesh()
    if mesh is None or RING_AXIS not in mesh.axis_names or mesh.shape[RING_AXIS] == 1:
        return plain_attention(q, k, v)
    if RING_AXIS in rules_for_mesh(mesh).batch_axes():
        raise ValueError(f"the mesh {mesh.shape} splits the batch over {RING_AXIS!r}, whose ranks "
                         "must hold the same rows for ring attention: add a 'data' axis")
    n = mesh.shape[RING_AXIS]
    s_q, s_k, heads = q.shape[1], k.shape[1], q.shape[2]
    if s_q == s_k and s_q % n == 0:
        return ring_self_attention(q, k, v, mesh)
    if heads % n == 0:
        return head_sharded_attention(q, k, v, mesh)
    return plain_attention(q, k, v)
