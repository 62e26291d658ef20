"""Fused pre-norm ViT block, forward and backward
(``csrc/fused_vit_block.cu``, its device code ``csrc/vit_block.cuh``), the
op behind ``vit_fused_block``.

Counterpart of ``soccerdiffusion_tpu/ops/fused_vit_block.py``
(``make_vit_block_fn``): over (N frames, T tokens, W) one block
``x2 = x + attn(LN1(x)); y = x2 + mlp(LN2(x2))`` with the block's GELU
(``vit_fused_gelu``: "exact" (erf), "quick" (z * sigmoid(1.702 z)), "poly"
(the JAX package's minimax polynomial of exact GELU, fp32) or "bf16"
(quick-GELU evaluated on z rounded to bf16, each op rounded to bf16, with
an fp32 sum of the bf16 dz for db1)), rounded to the compute dtype at the points of
the TPU kernel's ``_block_core``: bf16 input and output, fp32 LayerNorm,
q|k|v rounded after the bias, fp32 softmax with the probabilities rounded
before the value product, the head outputs rounded, fp32 residual, the GELU
input z in fp32 and its output rounded. Weights in ``STACK_WEIGHTS`` order
(``ops/fused_encoder_stack.py``), Dense kernels as (in, out).

The block is one layer of the fused encoder stack with the block's GELU, so
its plain versions are that op's at L = 1 (``forward_plain`` is
``_block_core``'s forward, ``backward_plain`` the hand-derived backward of
``_make_bwd_kernel``), and its backward kernel runs the stack's layer code.

``vit_block`` dispatches on x's device: a CUDA tensor launches the kernels
(bf16, head_dim 32 or 64) or raises, a CPU tensor runs the plain versions.
With grad it goes through ``FusedVitBlock``, the ``torch.autograd.Function``
over the 12 float32 masters, which saves x and the weights (as the JAX
custom_vjp saves ``(x, w)``) and returns float32 weight gradients; without
grad it takes the weights as given (packed once in the compute dtype by
``models/transformer.py:packed_weights``). ``forward_kernel.launches`` and
``backward_kernel.launches`` count kernel launches.

The backward has two paths, picked by the frame's shape (``row_tiled``):
the row-tiled kernels of ``csrc/vit_block_rows.cu`` (warpgroup products over
128-row tiles of all N T rows) at W = 256, and the per-frame kernel (one
thread block a frame) at the other widths; ``backward_kernel.row_tiled``
counts the launches of the first.
"""

from __future__ import annotations

import torch

from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
from soccerdiffusion_tpu_torch.ops._train_math import (
    GELUS,
    MAX_SMEM,
    ROWS_PER_SPLIT,
    check_operands,
    transposed_weights,
)


def _check_gelu(gelu: str) -> None:
    if gelu not in GELUS:
        raise ValueError(f"unknown vit_fused_gelu: {gelu!r} (the fused ViT block takes "
                         f"{', '.join(GELUS)})")


def gelu_code(gelu: str) -> int:
    """The kernels' GELU parameter (csrc/train_common.cuh:Gelu): its index in
    GELUS."""
    _check_gelu(gelu)
    return GELUS.index(gelu)


def forward_plain(x: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                  gelu: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, on any device:
    y (N, T, W) in x's dtype."""
    _check_gelu(gelu)
    return fes.forward_plain(x, [t[None] for t in w], num_heads, gelu)


def backward_plain(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                   gelu: str = "exact") -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The plain PyTorch version of the backward kernel: dx in x's dtype and
    the 12 float32 weight gradients."""
    _check_gelu(gelu)
    dx, grads = fes.backward_plain(x, dy, [t[None] for t in w], num_heads, gelu)
    return dx, [g[0] for g in grads]


def smem_bytes(T: int, W: int) -> int:
    """Shared memory of one frame's forward thread block
    (``csrc/vit_block.cuh:vit_smem_bytes``): the fp32 residual, the
    bf16 LayerNorm / attention output and q|k|v, rows padded by 8."""
    return 4 * T * W + fes.fwd_smem_bytes(T, W)


def _check(x: torch.Tensor, w: list[torch.Tensor], num_heads: int, gelu: str) -> None:
    _check_gelu(gelu)
    if x.dtype != torch.bfloat16 or any(t.dtype != torch.bfloat16 for t in w):
        raise ValueError("the CUDA ViT-block kernels take bfloat16 (compute_dtype='bfloat16'); "
                         f"got {x.dtype}")
    check_operands(x, w, num_heads, w[8].shape[-1], 3 * num_heads * x.shape[1])


def forward_kernel(x: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                   gelu: str = "exact") -> torch.Tensor:
    """The forward kernel on CUDA tensors: y (N, T, W) bf16; ``w`` bf16."""
    _check(x, w, num_heads, gelu)
    N, T, W = x.shape
    if smem_bytes(T, W) > MAX_SMEM:
        raise ValueError(f"a frame of {T} tokens x {W} does not fit one thread block's shared "
                         "memory")
    x = x.contiguous()
    w = [t.contiguous() for t in w]
    y = torch.empty_like(x)
    err = _build.library().sd_vit_block_fwd(
        _build.pointers(x, *w, y, *transposed_weights(w)),
        _build.ints(N, T, W, num_heads, w[8].shape[-1], gelu_code(gelu)),
        _build.stream(x.device))
    _build.check("sd_vit_block_fwd", err)
    forward_kernel.launches += 1
    return y


# The row-tiled backward (csrc/vit_block_rows.cu): the rows of a product
# tile, the one width its LayerNorm epilogues take (a 256-column tile spans a
# row) and the MLP columns of a weight-gradient tile (dw1's output columns;
# the GELU tile takes 128). At that width it is the faster path at every
# frame count measured on the card (PERF.md), so the shape alone picks the
# path.
ROW_TILE = 128
ROW_TILED_WIDTH = 256
ROW_TILED_FF_TILE = 256


def row_tiled_smem_bytes(T: int, W: int, H: int) -> int:
    """Shared memory of the row-tiled path's attention backward, one head of
    one frame a block (``csrc/vit_block_rows.cu:head_attn_smem``): the
    head's q|k|v and dom columns, rows padded by 8, and 3 T fp32 softmax
    statistics."""
    D = W // H
    return 2 * T * (3 * D + 8) + 2 * T * (D + 8) + 12 * T


def row_tiled(T: int, W: int, H: int, FF: int) -> bool:
    """Whether the backward over frames of T tokens x W (H heads, MLP width
    FF) takes the row-tiled kernels: W = 256, FF a multiple of 256 and a
    frame's attention operands within one block's shared memory; else the
    per-frame kernel."""
    return (W == ROW_TILED_WIDTH and FF % ROW_TILED_FF_TILE == 0
            and row_tiled_smem_bytes(T, W, H) <= MAX_SMEM)


def row_tiled_scratch(N: int, T: int, W: int, FF: int,
                      partials: int) -> list[tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each scratch buffer of the row-tiled backward, in the
    order of ``sd_vit_block_bwd_rows``' pointers: the row operands n1, q|k|v,
    om, x2, n2, hg, dzc, dx2, da, dom, dq|dk|dv (R = N T rows); the vector
    gradients' partials: bqkv a frame, [g1|be1], [bo|g2|be2], b1 and b2 a row
    tile; the weight-gradient products' ``partials`` floats, which the C side
    sizes from the device (``sd_vit_block_bwd_rows_partials``)."""
    R, tiles = N * T, -(-N * T // ROW_TILE)
    bf, f32 = torch.bfloat16, torch.float32
    return [((R, W), bf), ((R, 3 * W), bf), ((R, W), bf), ((R, W), f32), ((R, W), bf),
            ((R, FF), bf), ((R, FF), bf), ((R, W), f32), ((R, W), bf), ((R, W), bf),
            ((R, 3 * W), bf),
            ((N, 3 * W), f32), ((tiles, 2 * W), f32), ((tiles, 3 * W), f32), ((tiles, FF), f32),
            ((tiles, W), f32),
            ((partials,), f32)]


def _check_backward(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                    gelu: str) -> None:
    _check(x, w, num_heads, gelu)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: got {tuple(dy.shape)} {dy.dtype} on {dy.device}, x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def backward_kernel(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                    gelu: str = "exact") -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The backward kernels on CUDA tensors: dx (bf16) and the 12 float32
    weight gradients, summed over the frames in a fixed order; the row-tiled
    kernels where ``row_tiled`` takes the shape, else the per-frame kernel."""
    _check_backward(x, dy, w, num_heads, gelu)
    if row_tiled(x.shape[1], x.shape[2], num_heads, w[8].shape[-1]):
        return backward_row_tiled(x, dy, w, num_heads, gelu)
    return backward_per_frame(x, dy, w, num_heads, gelu)


def backward_per_frame(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                       gelu: str = "exact") -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The per-frame backward kernel (``vit_block_bwd_kernel``, one thread
    block a frame) at any shape the kernels take."""
    _check_backward(x, dy, w, num_heads, gelu)
    N, T, W = x.shape
    FF = w[8].shape[-1]
    x, dy = x.contiguous(), dy.contiguous()
    w = [t.contiguous() for t in w]
    wt = transposed_weights(w)
    outs, scratch, (s32, sbf) = fes.backward_buffers(1, N, T, W, FF, x.device)
    dx = torch.empty_like(x)
    err = _build.library().sd_vit_block_bwd(
        _build.pointers(x, dy, *w, *wt, dx, *outs, *scratch),
        _build.ints(N, T, W, num_heads, FF, gelu_code(gelu), s32, sbf, ROWS_PER_SPLIT),
        _build.stream(x.device))
    _build.check("sd_vit_block_bwd", err)
    backward_kernel.launches += 1
    return dx, [g[0] for g in fes.stacked_grads(outs, W, FF)]


def backward_row_tiled(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                       gelu: str = "exact") -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The row-tiled backward kernels (``csrc/vit_block_rows.cu``) at any
    frame count of a shape that ``row_tiled`` takes."""
    _check_backward(x, dy, w, num_heads, gelu)
    N, T, W = x.shape
    FF = w[8].shape[-1]
    if not row_tiled(T, W, num_heads, FF):
        raise ValueError(f"the row-tiled ViT backward takes W={ROW_TILED_WIDTH}, an MLP width that "
                         f"is a multiple of {ROW_TILED_FF_TILE} and a frame's attention operands "
                         f"in {MAX_SMEM} bytes; got T={T}, W={W}, FF={FF}")
    dev = x.device
    x, dy = x.contiguous(), dy.contiguous()
    w = [t.contiguous() for t in w]
    # wqkv, wo and w1 as (out, in); the dhg product reads w2 as it lies
    wt = [w[i].transpose(-1, -2).contiguous() for i in (2, 4, 8)]
    outs = [torch.empty((1, W, 3 * W), device=dev), torch.empty((1, W, W), device=dev),
            torch.empty((1, W, FF), device=dev), torch.empty((1, FF, W), device=dev),
            torch.empty((1, 9 * W + FF), device=dev)]
    lib = _build.library()
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):  # the C side sizes the splits from this device's SMs
        partials = lib.sd_vit_block_bwd_rows_partials(_build.ints(N, T, W, FF))
        if partials < 0:
            raise RuntimeError(f"sd_vit_block_bwd_rows_partials could not read {dev}")
        scratch = [torch.empty(shape, dtype=dtype, device=dev)
                   for shape, dtype in row_tiled_scratch(N, T, W, FF, partials)]
        err = lib.sd_vit_block_bwd_rows(_build.pointers(x, dy, *w, *wt, dx, *outs, *scratch),
                                        _build.ints(N, T, W, num_heads, FF, gelu_code(gelu)),
                                        _build.stream(dev))
    _build.check("sd_vit_block_bwd_rows", err)
    backward_kernel.launches += 1
    backward_kernel.row_tiled += 1
    return dx, [g[0] for g in fes.stacked_grads(outs, W, FF)]


forward_kernel.launches = 0
backward_kernel.launches = 0
backward_kernel.row_tiled = 0


class FusedVitBlock(torch.autograd.Function):
    """(x, num_heads, gelu, *12 float32 weights) -> y."""

    @staticmethod
    def forward(ctx, x, num_heads, gelu, *weights):
        w = [t.to(x.dtype) for t in weights]
        ctx.num_heads, ctx.gelu = num_heads, gelu
        ctx.save_for_backward(x, *w)
        if x.is_cuda:
            return forward_kernel(x, w, num_heads, gelu)
        return forward_plain(x, w, num_heads, gelu)

    @staticmethod
    def backward(ctx, dy):
        x, *w = ctx.saved_tensors
        if dy.is_cuda:
            dx, grads = backward_kernel(x, dy, w, ctx.num_heads, ctx.gelu)
        else:
            dx, grads = backward_plain(x, dy, w, ctx.num_heads, ctx.gelu)
        return (dx, None, None, *grads)


def vit_block(x: torch.Tensor, weights: list[torch.Tensor], num_heads: int,
              gelu: str = "exact") -> torch.Tensor:
    """One fused ViT block: x (N, T, W) in the compute dtype, ``weights``
    the 12 float32 masters (cast to x's dtype here) or, without grad, their
    packed compute-dtype copies."""
    _check_gelu(gelu)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in weights)):
        return FusedVitBlock.apply(x, num_heads, gelu, *weights)
    w = [t.to(x.dtype) for t in weights]
    if x.is_cuda:
        return forward_kernel(x, w, num_heads, gelu)
    return forward_plain(x, w, num_heads, gelu)
