"""Fused pre-norm ViT block, forward and backward
(``csrc/fused_vit_block.cu``), the op behind ``vit_fused_block``.

Counterpart of ``soccerdiffusion_tpu/ops/fused_vit_block.py``
(``make_vit_block_fn``): over (N frames, T tokens, W) one block
``x2 = x + attn(LN1(x)); y = x2 + mlp(LN2(x2))`` with exact (erf) or quick
(z * sigmoid(1.702 z)) GELU, rounded to the compute dtype at the points of
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
        raise NotImplementedError(f"vit_fused_gelu={gelu!r}: the fused ViT block takes "
                                  f"{' or '.join(GELUS)} (see ROADMAP.md, 'H100 port')")


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
    (``csrc/fused_vit_block.cu:vit_smem_bytes``): the fp32 residual, the
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
        _build.ints(N, T, W, num_heads, w[8].shape[-1], int(gelu == "quick")),
        _build.stream(x.device))
    _build.check("sd_vit_block_fwd", err)
    forward_kernel.launches += 1
    return y


def backward_kernel(x: torch.Tensor, dy: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                    gelu: str = "exact") -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The backward kernel on CUDA tensors: dx (bf16) and the 12 float32
    weight gradients, summed over the frames in a fixed order."""
    _check(x, w, num_heads, gelu)
    N, T, W = x.shape
    FF = w[8].shape[-1]
    x, dy = x.contiguous(), dy.contiguous()
    w = [t.contiguous() for t in w]
    wt = transposed_weights(w)
    outs, scratch, (s32, sbf) = fes.backward_buffers(1, N, T, W, FF, x.device)
    dx = torch.empty_like(x)
    err = _build.library().sd_vit_block_bwd(
        _build.pointers(x, dy, *w, *wt, dx, *outs, *scratch),
        _build.ints(N, T, W, num_heads, FF, int(gelu == "quick"), s32, sbf, ROWS_PER_SPLIT),
        _build.stream(x.device))
    _build.check("sd_vit_block_bwd", err)
    backward_kernel.launches += 1
    return dx, [g[0] for g in fes.stacked_grads(outs, W, FF)]


forward_kernel.launches = 0
backward_kernel.launches = 0


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
