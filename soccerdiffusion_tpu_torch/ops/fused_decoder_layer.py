"""Fused cross-attending decoder layer with a hand-written backward
(``csrc/fused_decoder_layer.cu``), the training op behind
``decoder_fused_block``.

Counterpart of ``soccerdiffusion_tpu/ops/fused_decoder_layer.py``
(``make_decoder_layer_fn``): one pre-norm layer
``x += self_attn(LN1(x)); x += cross_attn(LN2(x), memory); x += mlp(LN3(x))``
with the memory's K/V projected inside the kernel, exact GELU, fp32
LayerNorm / softmax / residual stream. Weights in ``WEIGHT_NAMES`` order,
Dense kernels as (in, out), self-attention q | k | v concatenated.

``FusedDecoderLayer`` is the ``torch.autograd.Function`` (see
``ops/fused_encoder_stack.py`` for the float32-master convention and the
dispatch). ``forward_plain`` follows ``_decoder_core`` line by line,
``backward_plain`` the hand-derived backward of ``_make_bwd_kernel``.
A CUDA tensor launches the kernels (bf16, head_dim 32 or 64; every product
on the tensor cores) or raises. The wrappers hand the kernels the weights
of their forward products transposed to (out, in) and the memory's K/V
projection ordered by head (``kernel_weights``), made once per call of the
op.
``FusedDecoderLayer.fwd_launches`` / ``.bwd_launches`` count kernel launches,
``.fwd_launches_hd64`` / ``.bwd_launches_hd64`` the head_dim-64 ones among them.
"""

from __future__ import annotations

import torch

from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops._train_math import (
    MAX_SMEM,
    ROWS_PER_SPLIT,
    attention,
    attention_bwd,
    check_operands,
    gelu_gate,
    gelu_grad,
    ln_bwd,
    ln_fwd,
    r4,
    r8,
    rnd,
    rsum,
    tdot,
)

WEIGHT_NAMES = (
    "g1", "be1", "wqkv", "bqkv", "wso", "bso",
    "g2", "be2", "wcq", "bcq", "wck", "bck", "wcv", "bcv", "wco", "bco",
    "g3", "be3", "w1", "b1", "w2", "b2",
)


def layer_weights(layer) -> list[torch.Tensor]:
    """The float32 master parameters of a ``TransformerDecoderLayer`` in
    ``WEIGHT_NAMES`` order (differentiable)."""
    sa, ca, mlp = layer.self_attn, layer.cross_attn, layer.mlp
    k = lambda lin: lin.full_weight().t()
    b = lambda lin: lin.full_bias()
    return [
        layer.norm1.weight, layer.norm1.bias,
        torch.cat([k(sa.q_proj), k(sa.k_proj), k(sa.v_proj)], dim=1),
        torch.cat([b(sa.q_proj), b(sa.k_proj), b(sa.v_proj)]),
        k(sa.out_proj), b(sa.out_proj),
        layer.norm2.weight, layer.norm2.bias,
        k(ca.q_proj), b(ca.q_proj), k(ca.k_proj), b(ca.k_proj),
        k(ca.v_proj), b(ca.v_proj), k(ca.out_proj), b(ca.out_proj),
        layer.norm3.weight, layer.norm3.bias,
        k(mlp.linear1), b(mlp.linear1), k(mlp.linear2), b(mlp.linear2),
    ]


def decoder_layer(x: torch.Tensor, mem: torch.Tensor, weights: list[torch.Tensor],
                  num_heads: int) -> torch.Tensor:
    """y (B, T, E) in x's dtype; mem (B, S, E) in the same dtype; ``weights``
    the 22 float32 masters."""
    return FusedDecoderLayer.apply(x, mem, num_heads, *weights)


# ------------------------------------------------------- plain versions

def _core(x, mem, w, num_heads):
    """The layer's forward with every intermediate (``_decoder_core``)."""
    dtype = x.dtype
    (g1, be1, wqkv, bqkv, wso, bso, g2, be2, wcq, bcq, wck, bck, wcv, bcv, wco, bco,
     g3, be3, w1, b1, w2, b2) = (t.float() for t in w)
    E = x.shape[-1]
    x32 = x.float()
    n1_32, xh1, r1 = ln_fwd(x32, g1, be1)
    n1 = rnd(n1_32, dtype)
    qkv = rnd(n1 @ wqkv + bqkv, dtype)
    q, k, v = qkv.split(E, dim=-1)
    p1, om1 = attention(q, k, v, num_heads, dtype)
    x2 = x32 + (om1 @ wso + bso)
    n2_32, xh2, r2 = ln_fwd(x2, g2, be2)
    n2 = rnd(n2_32, dtype)
    q2 = rnd(n2 @ wcq + bcq, dtype)
    memc = rnd(mem, dtype)
    k2 = rnd(memc @ wck + bck, dtype)
    v2 = rnd(memc @ wcv + bcv, dtype)
    p2, om2 = attention(q2, k2, v2, num_heads, dtype)
    x3 = x2 + (om2 @ wco + bco)
    n3_32, xh3, r3 = ln_fwd(x3, g3, be3)
    n3 = rnd(n3_32, dtype)
    z = n3 @ w1 + b1
    cdf = gelu_gate(z)
    hg = rnd(z * cdf, dtype)
    y = x3 + hg @ w2 + b2
    return dict(xh1=xh1, r1=r1, n1=n1, q=q, k=k, v=v, p1=p1, om1=om1, xh2=xh2, r2=r2, n2=n2,
                q2=q2, memc=memc, k2=k2, v2=v2, p2=p2, om2=om2, xh3=xh3, r3=r3, n3=n3, z=z,
                cdf=cdf, hg=hg, y=y)


def forward_plain(x, mem, w, num_heads) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, on any device."""
    return _core(x, mem, w, num_heads)["y"].to(x.dtype)


def backward_plain(x, mem, dy, w, num_heads):
    """The plain PyTorch version of the backward kernel: dx, dmem (in x's /
    mem's dtype) and the 22 float32 weight gradients."""
    dtype = x.dtype
    wf = [t.float() for t in w]
    g1, wqkv, wso, g2, wcq, wck, wcv, wco, g3, w1, w2 = (
        wf[i] for i in (0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20))
    c = _core(x, mem, w, num_heads)
    r = lambda t: rnd(t, dtype)
    g = dy.float()
    # MLP
    gc = r(g)
    dw2, db2 = tdot(c["hg"], gc), rsum(g)
    dz = (gc @ w2.t()) * gelu_grad(c["z"], c["cdf"])
    dzc = r(dz)
    dw1, db1 = tdot(c["n3"], dzc), rsum(dz)
    dn3 = dzc @ w1.t()
    dg3, dbe3 = rsum(dn3 * c["xh3"]), rsum(dn3)
    dx3 = g + ln_bwd(dn3, c["xh3"], c["r3"], g3)
    # cross-attention
    da2 = r(dx3)
    dwco, dbco = tdot(c["om2"], da2), rsum(dx3)
    dom2 = r(da2 @ wco.t())
    dq2, dk2, dv2 = attention_bwd(c["p2"], c["q2"], c["k2"], c["v2"], dom2, num_heads, dtype)
    dq2c, dk2c, dv2c = r(dq2), r(dk2), r(dv2)
    dwcq, dbcq = tdot(c["n2"], dq2c), rsum(dq2c)
    dwck, dbck = tdot(c["memc"], dk2c), rsum(dk2)
    dwcv, dbcv = tdot(c["memc"], dv2c), rsum(dv2)
    dmem = dk2c @ wck.t() + dv2c @ wcv.t()
    dn2 = dq2c @ wcq.t()
    dg2, dbe2 = rsum(dn2 * c["xh2"]), rsum(dn2)
    dx2 = dx3 + ln_bwd(dn2, c["xh2"], c["r2"], g2)
    # self-attention
    da1 = r(dx2)
    dwso, dbso = tdot(c["om1"], da1), rsum(dx2)
    dom1 = r(da1 @ wso.t())
    dq1, dk1, dv1 = attention_bwd(c["p1"], c["q"], c["k"], c["v"], dom1, num_heads, dtype)
    dqkv = torch.cat([r(dq1), r(dk1), r(dv1)], dim=-1)
    dwqkv, dbqkv = tdot(c["n1"], dqkv), rsum(dqkv)
    dn1 = dqkv @ wqkv.t()
    dg1, dbe1 = rsum(dn1 * c["xh1"]), rsum(dn1)
    dx = dx2 + ln_bwd(dn1, c["xh1"], c["r1"], g1)
    grads = [dg1, dbe1, dwqkv, dbqkv, dwso, dbso, dg2, dbe2, dwcq, dbcq, dwck, dbck,
             dwcv, dbcv, dwco, dbco, dg3, dbe3, dw1, db1, dw2, db2]
    return dx.to(dtype), dmem.to(mem.dtype), grads


# --------------------------------------------------------- CUDA kernels

def _ws_strides(T: int, S: int, E: int, FF: int) -> tuple[int, int]:
    """Per-robot fp32 / bf16 workspace elements of the backward
    (``csrc/fused_decoder_layer.cu:dec_carve``)."""
    key_tiles = -(-S // 16)
    return (10 * r4(T * E) + 2 * r4(T * FF) + 3 * r4(T) + 2 * r4(key_tiles * E),
            r8(3 * T * E) + 2 * r8(T * E) + 2 * r8(S * E))


# keys per chunk of the forward's split cross-attention, warps of its block
# (csrc/mma.cuh:kSplitKeys, csrc/encoder_layer.cuh:kFwdThreads / 32)
_SPLIT_KEYS, _FWD_WARPS = 32, 16


def _split_red(D: int, S: int, warps: int) -> int:
    """fp32 values of the split attention's reduction buffer
    (``csrc/mma.cuh:split_red_floats``)."""
    chunks = -(-S // _SPLIT_KEYS)
    return 32 * chunks + 16 * D * min(chunks, warps)


def _fwd_smem(T: int, S: int, E: int, FF: int, D: int) -> int:
    """Shared-memory bytes of the forward kernel
    (``csrc/fused_decoder_layer.cu:dec_fwd_smem_bytes``)."""
    return (4 * (T * E + _split_red(D, S, _FWD_WARPS))
            + 2 * (T * (E + 8) + T * (max(3 * E, FF) + 8) + 2 * S * (D + 8)))


def _check(x, mem, w, num_heads):
    B, T, E = x.shape
    if mem.dtype != x.dtype or mem.shape[0] != B or mem.shape[2] != E:
        raise ValueError(f"memory {tuple(mem.shape)} {mem.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    FF = w[18].shape[-1]
    S, D = mem.shape[1], E // num_heads
    # the backward's shared memory, in fp32 values: softmax stats, q2 | dom
    check_operands(x, w, num_heads, FF, r4(3 * num_heads * T) + T * (E + 4))
    if _fwd_smem(T, S, E, FF, D) > MAX_SMEM:
        raise ValueError(f"T={T} chunk rows over S={S} memory rows at E={E} exceed one thread "
                         "block's shared memory in the CUDA decoder-layer forward")
    return B, T, S, E, FF


def kernel_weights(w, num_heads) -> list[torch.Tensor]:
    """The layouts the kernels read besides the 22 (contiguous) weights
    ``w``, made once per call of the op and shared by its forward and
    backward: the forward products' weights transposed to (out, in) (the
    reduction axis contiguous, ``csrc/mma.cuh``) -- wqkv, wso, wcq, wco, w1,
    w2 -- then the memory's K/V projection by head, wkv_t (2E, E) with rows
    h 2D .. h 2D + D - 1 the key columns of head h and the next D its value
    columns, its bias bkv (2E) in the same order (a head's K | V is one
    product), and wkvc = [wck | wcv] (E, 2E) for the backward's dmem. Six
    copies: the weights with E inputs side by side, transposed at once."""
    E, FF = w[0].shape[0], w[18].shape[1]
    H, D = num_heads, w[0].shape[0] // num_heads
    wkv = torch.cat([w[10].view(E, H, D), w[12].view(E, H, D)], dim=2).view(E, 2 * E)
    wide_t = torch.cat([w[2], w[4], w[8], w[14], w[18], wkv], dim=1).t().contiguous()
    wqkv_t, wso_t, wcq_t, wco_t, w1_t, wkv_t = wide_t.split([3 * E, E, E, E, FF, 2 * E])
    bkv = torch.cat([w[11].view(H, D), w[13].view(H, D)], dim=1).view(2 * E)
    wkvc = torch.cat([w[10], w[12]], dim=1)
    return [wqkv_t, wso_t, wcq_t, wco_t, w1_t, w[20].t().contiguous(), wkv_t, bkv, wkvc]


def forward_kernel(x, mem, w, num_heads, kw=None) -> torch.Tensor:
    """The forward kernel on CUDA tensors: y (B, T, E) bf16 (``kw``: the
    weights' kernel_weights, made here if not given)."""
    B, T, S, E, FF = _check(x, mem, w, num_heads)
    w = [t.contiguous() for t in w]
    kw = kernel_weights(w, num_heads) if kw is None else kw
    y = torch.empty_like(x)
    err = _build.library().sd_decoder_layer_fwd(
        _build.pointers(x.contiguous(), mem.contiguous(), *w, *kw[:8], y),
        _build.ints(B, T, S, E, num_heads, FF), _build.stream(x.device))
    _build.check("sd_decoder_layer_fwd", err)
    FusedDecoderLayer.fwd_launches += 1
    FusedDecoderLayer.fwd_launches_hd64 += E == 64 * num_heads
    return y


def backward_kernel(x, mem, dy, w, num_heads, kw=None):
    """The backward kernel on CUDA tensors: dx, dmem (bf16) and the 22
    float32 weight gradients, summed over the batch in a fixed order
    (``kw``: the weights' kernel_weights, made here if not given)."""
    B, T, S, E, FF = _check(x, mem, w, num_heads)
    dev = x.device
    w = [t.contiguous() for t in w]
    kw = kernel_weights(w, num_heads) if kw is None else kw
    s32, sbf = _ws_strides(T, S, E, FF)
    V = 15 * E + FF  # g1 be1 bqkv(3E) bso g2 be2 bcq bck bcv bco g3 be3 b1(FF) b2
    dx, dmem = torch.empty_like(x), torch.empty_like(mem)
    shapes = [(E, 3 * E), (E, E), (E, E), (E, E), (E, E), (E, E), (E, FF), (FF, E)]
    mats = [torch.empty(s, device=dev) for s in shapes]
    gvec = torch.empty(V, device=dev)
    rows = [B * T, B * T, B * T, B * S, B * S, B * T, B * T, B * T]
    tpart = torch.empty(sum(-(-r // ROWS_PER_SPLIT) * a * b for r, (a, b) in zip(rows, shapes)),
                        device=dev)
    ws32 = torch.empty((B, s32), device=dev)
    wsbf = torch.empty((B, sbf), dtype=torch.bfloat16, device=dev)
    saved = torch.empty((B * T, 12 * E + 2 * FF), dtype=torch.bfloat16, device=dev)
    saved_mem = torch.empty((B * S, 2 * E), dtype=torch.bfloat16, device=dev)
    vpart = torch.empty((B, V), device=dev)
    err = _build.library().sd_decoder_layer_bwd(
        _build.pointers(x.contiguous(), mem.contiguous(), dy.contiguous(), *w, *kw, dx, dmem,
                        *mats, gvec, ws32, wsbf, saved, saved_mem, vpart, tpart),
        _build.ints(B, T, S, E, num_heads, FF, s32, sbf, ROWS_PER_SPLIT), _build.stream(dev))
    _build.check("sd_decoder_layer_bwd", err)
    FusedDecoderLayer.bwd_launches += 1
    FusedDecoderLayer.bwd_launches_hd64 += E == 64 * num_heads
    (dg1, dbe1, dbqkv, dbso, dg2, dbe2, dbcq, dbck, dbcv, dbco, dg3, dbe3, db1,
     db2) = gvec.split([E, E, 3 * E, E, E, E, E, E, E, E, E, E, FF, E])
    dwqkv, dwso, dwcq, dwck, dwcv, dwco, dw1, dw2 = mats
    grads = [dg1, dbe1, dwqkv, dbqkv, dwso, dbso, dg2, dbe2, dwcq, dbcq, dwck, dbck,
             dwcv, dbcv, dwco, dbco, dg3, dbe3, dw1, db1, dw2, db2]
    return dx, dmem, grads


class FusedDecoderLayer(torch.autograd.Function):
    """(x, mem, num_heads, *22 float32 weights) -> y."""

    fwd_launches = 0
    fwd_launches_hd64 = 0
    bwd_launches = 0
    bwd_launches_hd64 = 0

    @staticmethod
    def forward(ctx, x, mem, num_heads, *weights):
        w = [t.to(x.dtype).contiguous() for t in weights]
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, mem, *w)
        if x.is_cuda:
            ctx.kw = kernel_weights(w, num_heads)  # shared with the backward
            return forward_kernel(x, mem, w, num_heads, ctx.kw)
        return forward_plain(x, mem, w, num_heads)

    @staticmethod
    def backward(ctx, dy):
        x, mem, *w = ctx.saved_tensors
        if dy.is_cuda:
            dx, dmem, grads = backward_kernel(x, mem, dy, w, ctx.num_heads, ctx.kw)
        else:
            dx, dmem, grads = backward_plain(x, mem, dy, w, ctx.num_heads)
        return (dx, dmem, None, *grads)
