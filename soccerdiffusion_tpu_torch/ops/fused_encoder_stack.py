"""Fused L-layer transformer-encoder stack with a hand-written backward
(``csrc/fused_encoder_stack.cu``), the training op behind
``encoder_fused_stack``.

Counterpart of ``soccerdiffusion_tpu/ops/fused_encoder_stack.py``
(``make_encoder_stack_fn``): per layer, pre-norm
``x += attn(LN1(x)); x += mlp(LN2(x))`` with exact GELU, the residual
stream kept fp32 across all L layers and rounded to the compute dtype only
at the output. The weights are stacked on a leading L axis in
``STACK_WEIGHTS`` order, Dense kernels as (in, out), q | k | v concatenated.

``FusedEncoderStack`` is the ``torch.autograd.Function``. It takes the
float32 master weights and casts them to the compute dtype (the dtype of
x) inside, so the weight gradients it returns, float32, reach the
parameters unrounded (a bf16 input would have its float32 gradient rounded
to bf16 by the autograd engine). A CUDA tensor launches the kernels (bf16,
head_dim 32 or 64) or raises; a CPU tensor runs the plain versions below,
which follow the TPU kernel's casts line by line: ``forward_plain`` is
``_stack_core`` over the layers, ``backward_plain`` the hand-derived
backward of ``_make_bwd_kernel`` (not autograd), so that on the card
kernel and plain version differ by summation order only. Both take the
GELU as an argument for the fused ViT block (``ops/fused_vit_block.py``),
which is one such layer; the stack itself is exact GELU.
``FusedEncoderStack.fwd_launches`` / ``.bwd_launches`` count kernel launches;
``.fwd_launches_hd64`` / ``.bwd_launches_hd64`` count the head_dim-64
launches among them.
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
    transposed_weights,
)

STACK_WEIGHTS = ("g1", "be1", "wqkv", "bqkv", "wo", "bo", "g2", "be2", "w1", "b1", "w2", "b2")


def encoder_layer_weights(layer) -> list[torch.Tensor]:
    """The float32 master parameters of one ``TransformerEncoderLayer`` in
    ``STACK_WEIGHTS`` order (differentiable), Dense kernels as (in, out)."""
    kernel = lambda lin: lin.weight.t()
    sa = layer.self_attn
    return [layer.norm1.weight, layer.norm1.bias,
            torch.cat([kernel(sa.q_proj), kernel(sa.k_proj), kernel(sa.v_proj)], dim=1),
            torch.cat([sa.q_proj.bias, sa.k_proj.bias, sa.v_proj.bias]),
            kernel(sa.out_proj), sa.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
            kernel(layer.mlp.linear1), layer.mlp.linear1.bias,
            kernel(layer.mlp.linear2), layer.mlp.linear2.bias]


def stack_weights(layers) -> list[torch.Tensor]:
    """``encoder_layer_weights`` of each layer stacked on a leading L axis."""
    return [torch.stack(ws) for ws in zip(*(encoder_layer_weights(lyr) for lyr in layers))]


def encoder_stack(x: torch.Tensor, weights: list[torch.Tensor], num_heads: int) -> torch.Tensor:
    """y (B, T, E) in x's dtype; ``weights`` stacked (L, ...) float32 masters."""
    return FusedEncoderStack.apply(x, num_heads, *weights)


# ------------------------------------------------------- plain versions

def _layer(x32, w, num_heads, dtype, gelu="exact"):
    """One layer's forward with every intermediate (``_stack_core``)."""
    g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1, w2, b2 = (t.float() for t in w)
    E = x32.shape[-1]
    n1_32, xh1, r1 = ln_fwd(x32, g1, be1)
    n1 = rnd(n1_32, dtype)
    qkv = rnd(n1 @ wqkv + bqkv, dtype)
    q, k, v = qkv.split(E, dim=-1)
    p, om = attention(q, k, v, num_heads, dtype)
    x2 = x32 + (om @ wo + bo)
    n2_32, xh2, r2 = ln_fwd(x2, g2, be2)
    n2 = rnd(n2_32, dtype)
    z = n2 @ w1 + b1
    cdf = gelu_gate(z, gelu)
    hg = rnd(z * cdf, dtype)
    y = x2 + hg @ w2 + b2
    return dict(xh1=xh1, r1=r1, n1=n1, q=q, k=k, v=v, p=p, om=om, xh2=xh2, r2=r2, n2=n2,
                z=z, cdf=cdf, hg=hg, y=y)


def forward_plain(x: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                  gelu: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, on any device."""
    x32 = x.float()
    for l in range(w[0].shape[0]):
        x32 = _layer(x32, [t[l] for t in w], num_heads, x.dtype, gelu)["y"]
    return x32.to(x.dtype)


def backward_plain(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                   gelu: str = "exact") -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The plain PyTorch version of the backward kernel: dx in x's dtype and
    the 12 stacked float32 weight gradients."""
    dtype, L = x.dtype, w[0].shape[0]
    xs = [x.float()]
    for l in range(L - 1):
        xs.append(_layer(xs[-1], [t[l] for t in w], num_heads, dtype, gelu)["y"])
    g = dy.float()
    grads = [[None] * L for _ in STACK_WEIGHTS]
    for l in reversed(range(L)):
        wl = [t[l].float() for t in w]
        g1, _, wqkv, _, wo, _, g2, _, w1, _, w2, _ = wl
        c = _layer(xs[l], wl, num_heads, dtype, gelu)
        # MLP
        gc = rnd(g, dtype)
        dw2, db2 = tdot(c["hg"], gc), rsum(g)
        dz = (gc @ w2.t()) * gelu_grad(c["z"], c["cdf"], gelu)
        dzc = rnd(dz, dtype)
        dw1, db1 = tdot(c["n2"], dzc), rsum(dz)
        dn2 = dzc @ w1.t()
        dg2, dbe2 = rsum(dn2 * c["xh2"]), rsum(dn2)
        dx2 = g + ln_bwd(dn2, c["xh2"], c["r2"], g2)
        # attention
        da = rnd(dx2, dtype)
        dwo, dbo = tdot(c["om"], da), rsum(dx2)
        dom = rnd(da @ wo.t(), dtype)
        dq, dk, dv = attention_bwd(c["p"], c["q"], c["k"], c["v"], dom, num_heads, dtype)
        dqkv = torch.cat([rnd(dq, dtype), rnd(dk, dtype), rnd(dv, dtype)], dim=-1)
        dwqkv, dbqkv = tdot(c["n1"], dqkv), rsum(dqkv)
        dn1 = dqkv @ wqkv.t()
        dg1, dbe1 = rsum(dn1 * c["xh1"]), rsum(dn1)
        g = dx2 + ln_bwd(dn1, c["xh1"], c["r1"], g1)
        for i, grad in enumerate((dg1, dbe1, dwqkv, dbqkv, dwo, dbo, dg2, dbe2, dw1, db1, dw2, db2)):
            grads[i][l] = grad
    return g.to(dtype), [torch.stack(gs) for gs in grads]


# --------------------------------------------------------- CUDA kernels

def _ws_strides(T: int, E: int, FF: int) -> tuple[int, int]:
    """Per-robot fp32 / bf16 workspace elements (``csrc/fused_encoder_stack.cu:carve``)."""
    return (6 * r4(T * E) + 2 * r4(T * FF) + 2 * r4(T),
            r8(3 * T * E) + r8(T * E))


def fwd_smem_bytes(T: int, E: int) -> int:
    """Shared memory of one robot's forward thread block
    (``csrc/encoder_layer.cuh:fwd_smem_bytes``): the bf16 LayerNorm /
    attention output and q|k|v, rows padded by 8."""
    return 2 * T * ((E + 8) + (3 * E + 8))


def forward_kernel(x: torch.Tensor, w: list[torch.Tensor],
                   num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: y (B, T, E) bf16 and the fp32
    input of every layer, acts (L, B, T, E), kept for the backward."""
    (B, T, E), L, FF = x.shape, w[0].shape[0], w[8].shape[-1]
    check_operands(x, w, num_heads, FF, 3 * num_heads * T)
    if fwd_smem_bytes(T, E) > MAX_SMEM:
        raise ValueError(f"a robot's {T} tokens x {E} do not fit one thread block's shared "
                         "memory")
    dev = x.device
    x = x.contiguous()
    w = [t.contiguous() for t in w]
    wt = transposed_weights(w)
    y = torch.empty_like(x)
    acts = torch.empty((L, B, T, E), dtype=torch.float32, device=dev)
    last = torch.empty((B, r4(T * E)), dtype=torch.float32, device=dev)  # the last layer's output
    err = _build.library().sd_encoder_stack_fwd(
        _build.pointers(x, *w, y, acts, last, None, None, *wt),
        _build.ints(B, T, E, num_heads, FF, L, r4(T * E), 0), _build.stream(dev))
    _build.check("sd_encoder_stack_fwd", err)
    FusedEncoderStack.fwd_launches += 1
    FusedEncoderStack.fwd_launches_hd64 += E == 64 * num_heads
    return y, acts


def backward_buffers(L: int, B: int, T: int, E: int, FF: int, dev) -> tuple[list, list, tuple]:
    """What a backward kernel over B blocks of T rows and L layers writes:
    the 4 stacked weight-matrix gradients and the (L, 9E + FF) vector
    gradients, the scratch (ws32, wsbf, saved, vpart, tpart), and the
    workspace strides."""
    s32, sbf = _ws_strides(T, E, FF)
    V = 9 * E + FF  # g1 be1 bqkv(3E) bo g2 be2 b1(FF) b2
    mats = [torch.empty((L, E, 3 * E), device=dev), torch.empty((L, E, E), device=dev),
            torch.empty((L, E, FF), device=dev), torch.empty((L, FF, E), device=dev)]
    splits = -(-B * T // ROWS_PER_SPLIT)
    scratch = [torch.empty((B, s32), device=dev),
               torch.empty((B, sbf), dtype=torch.bfloat16, device=dev),
               torch.empty((L, B * T, 8 * E + 2 * FF), dtype=torch.bfloat16, device=dev),
               torch.empty((B, L, V), device=dev),
               torch.empty(splits * L * (E * 3 * E + E * E + 2 * E * FF), device=dev)]
    return [*mats, torch.empty((L, V), device=dev)], scratch, (s32, sbf)


def stacked_grads(outs: list[torch.Tensor], E: int, FF: int) -> list[torch.Tensor]:
    """``backward_buffers``' outputs as the 12 gradients in STACK_WEIGHTS order."""
    *mats, gvec = outs
    vec = gvec.split([E, E, 3 * E, E, E, E, FF, E], dim=1)
    return [vec[0], vec[1], mats[0], vec[2], mats[1], vec[3], vec[4], vec[5], mats[2], vec[6],
            mats[3], vec[7]]


def backward_kernel(acts: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor],
                    num_heads: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The backward kernel on CUDA tensors: dx (bf16) and the 12 stacked
    float32 weight gradients, summed over the batch in a fixed order."""
    L, B, T, E = acts.shape
    FF = w[8].shape[-1]
    check_operands(dy, w, num_heads, FF, 3 * num_heads * T)
    dy = dy.contiguous()
    w = [t.contiguous() for t in w]
    wt = transposed_weights(w)
    outs, scratch, (s32, sbf) = backward_buffers(L, B, T, E, FF, dy.device)
    dx = torch.empty_like(dy)
    err = _build.library().sd_encoder_stack_bwd(
        _build.pointers(acts, dy, *w, *wt, dx, *outs, *scratch),
        _build.ints(B, T, E, num_heads, FF, L, s32, sbf, ROWS_PER_SPLIT), _build.stream(dy.device))
    _build.check("sd_encoder_stack_bwd", err)
    FusedEncoderStack.bwd_launches += 1
    FusedEncoderStack.bwd_launches_hd64 += E == 64 * num_heads
    return dx, stacked_grads(outs, E, FF)


class FusedEncoderStack(torch.autograd.Function):
    """(x, num_heads, *12 stacked float32 weights) -> y."""

    fwd_launches = 0
    fwd_launches_hd64 = 0
    bwd_launches = 0
    bwd_launches_hd64 = 0

    @staticmethod
    def forward(ctx, x, num_heads, *weights):
        w = [t.to(x.dtype) for t in weights]
        ctx.num_heads = num_heads
        if x.is_cuda:
            y, acts = forward_kernel(x, w, num_heads)
            ctx.save_for_backward(acts, *w)
        else:
            y = forward_plain(x, w, num_heads)
            ctx.save_for_backward(x, *w)
        return y

    @staticmethod
    def backward(ctx, dy):
        first, *w = ctx.saved_tensors
        if dy.is_cuda:
            dx, grads = backward_kernel(first, dy, w, ctx.num_heads)
        else:
            dx, grads = backward_plain(first, dy, w, ctx.num_heads)
        return (dx, None, *grads)
