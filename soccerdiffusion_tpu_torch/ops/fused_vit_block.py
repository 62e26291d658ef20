"""Fused pre-norm ViT block, forward (``csrc/fused_vit_block.cu``), the op
behind ``vit_fused_block``.

Counterpart of ``soccerdiffusion_tpu/ops/fused_vit_block.py``
(``make_vit_block_fn``'s forward): over (N frames, T tokens, W) one block
``x2 = x + attn(LN1(x)); y = x2 + mlp(LN2(x2))`` with exact (erf) or quick
(z * sigmoid(1.702 z)) GELU, rounded to the compute dtype at the points of
the TPU kernel's ``_block_core``: bf16 input and output, fp32 LayerNorm,
q|k|v rounded after the bias, fp32 softmax with the probabilities rounded
before the value product, the head outputs rounded, fp32 residual, the GELU
input z in fp32 and its output rounded. Weights in ``STACK_WEIGHTS`` order
(``ops/fused_encoder_stack.py``), Dense kernels as (in, out).

``vit_block`` casts the weights to x's dtype and dispatches on x's device: a
CUDA tensor launches the kernel (bf16, head_dim 32 or 64) or raises, a CPU
tensor runs ``forward_plain``. The backward kernel comes with the training
slice (ROADMAP.md): a CUDA call that would need a gradient raises.
``forward_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops._train_math import MAX_SMEM, attention, gelu_cdf, ln_fwd, rnd

GELUS = ("exact", "quick")


def _check_gelu(gelu: str) -> None:
    if gelu not in GELUS:
        raise NotImplementedError(f"vit_fused_gelu={gelu!r}: the fused ViT block takes "
                                  f"{' or '.join(GELUS)} (see ROADMAP.md, 'H100 port')")


def gelu_gate(z: torch.Tensor, gelu: str) -> torch.Tensor:
    """cdf(z) of GELU(z) = z * cdf(z), fp32: Phi(z), or sigmoid(1.702 z) for quick-GELU."""
    return 1.0 / (1.0 + torch.exp(-1.702 * z)) if gelu == "quick" else gelu_cdf(z)


def forward_plain(x: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                  gelu: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: y (N, T, W)
    in x's dtype."""
    _check_gelu(gelu)
    g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1, w2, b2 = (t.float() for t in w)
    dtype, W = x.dtype, x.shape[-1]
    x32 = x.float()
    n1 = rnd(ln_fwd(x32, g1, be1)[0], dtype)
    q, k, v = rnd(n1 @ wqkv + bqkv, dtype).split(W, dim=-1)
    x2 = x32 + (attention(q, k, v, num_heads, dtype)[1] @ wo + bo)
    n2 = rnd(ln_fwd(x2, g2, be2)[0], dtype)
    z = n2 @ w1 + b1
    hg = rnd(z * gelu_gate(z, gelu), dtype)
    return (x2 + hg @ w2 + b2).to(dtype)


def smem_bytes(T: int, W: int) -> int:
    """Shared memory of one frame's thread block (``csrc/fused_vit_block.cu:vit_smem_bytes``)."""
    return 4 * (T * W + -(-T * T // 4) * 4) + 2 * (T * W + T * (3 * W + 8))


def forward_kernel(x: torch.Tensor, w: list[torch.Tensor], num_heads: int,
                   gelu: str = "exact") -> torch.Tensor:
    """The CUDA kernel on CUDA tensors: y (N, T, W) bf16; ``w`` bf16."""
    _check_gelu(gelu)
    N, T, W = x.shape
    FF = w[8].shape[-1]
    if x.dtype != torch.bfloat16 or any(t.dtype != torch.bfloat16 for t in w):
        raise ValueError("the CUDA ViT-block kernel takes bfloat16 (compute_dtype='bfloat16'); "
                         f"got {x.dtype}")
    if W not in (32 * num_heads, 64 * num_heads):
        raise ValueError(f"the CUDA ViT-block kernel takes head_dim 32 or 64, got {W / num_heads:g}")
    if W % 8 or FF % 8:
        raise ValueError(f"the CUDA ViT-block kernel takes widths that are multiples of 8, "
                         f"got W={W}, FF={FF}")
    if smem_bytes(T, W) > MAX_SMEM:
        raise ValueError(f"a frame of {T} tokens x {W} does not fit one thread block's shared "
                         "memory")
    if any(t.device != x.device for t in w):
        raise ValueError("weights and frames must be on one CUDA device")
    x = x.contiguous()
    w = [t.contiguous() for t in w]
    y = torch.empty_like(x)
    err = _build.library().sd_vit_block_fwd(
        _build.pointers(x, *w, y),
        _build.ints(N, T, W, num_heads, FF, int(gelu == "quick")),
        _build.stream(x.device))
    _build.check("sd_vit_block_fwd", err)
    forward_kernel.launches += 1
    return y


forward_kernel.launches = 0


def vit_block(x: torch.Tensor, weights: list[torch.Tensor], num_heads: int,
              gelu: str = "exact") -> torch.Tensor:
    """One fused ViT block: x (N, T, W) in the compute dtype, ``weights``
    the 12 float32 masters (cast to x's dtype here). No backward on the card
    yet: a CUDA call with grad enabled and an input that requires grad
    raises ``NotImplementedError``."""
    w = [t.to(x.dtype) for t in weights]
    if not x.is_cuda:
        return forward_plain(x, w, num_heads, gelu)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in weights)):
        raise NotImplementedError("the fused ViT block's backward kernel comes with the "
                                  "flagship training slice (see ROADMAP.md, 'H100 port'); "
                                  "serve under torch.no_grad()")
    return forward_kernel(x, w, num_heads, gelu)
