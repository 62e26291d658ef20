"""Math and operand checks shared by the training ops
(``ops/fused_encoder_stack.py``, ``ops/fused_decoder_layer.py`` and
``ops/fused_vit_block.py``).

The plain pieces follow the TPU kernels' casts: fp32 LayerNorm, softmax and
residual stream; ``rnd`` marks each rounding to the compute dtype before
the next product. ``check_operands`` states what the CUDA training kernels
take, and the sizes below mirror ``csrc/weight_grads.cu`` and the
shared-memory budget of one H100 thread block.
"""

from __future__ import annotations

import math

import torch

# flax's LayerNorm default, which the kernels hard-code (torch's 1e-5 would
# be a silent mismatch); the models' LayerNorms take it from here
LN_EPS = 1e-6
# rows of each chunk of the weight-gradient products (csrc/weight_grads.cu)
ROWS_PER_SPLIT = 1024
# shared memory of one thread block on an H100 (232,448 bytes)
MAX_SMEM = 232448


def rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype`` and compute on in float32."""
    return t.to(dtype).float()


def ln_fwd(x32, g, b):
    """fp32 LayerNorm: (out, xhat, rstd)."""
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    return xhat * g.float() + b.float(), xhat, rstd


def ln_bwd(dn, xhat, rstd, g):
    """Input gradient of the LayerNorm (fp32)."""
    dxhat = dn * g.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2)


GELUS = ("exact", "quick")


def gelu_gate(z, gelu="exact"):
    """cdf(z) of GELU(z) = z * cdf(z), fp32: the normal CDF Phi(z), or
    sigmoid(1.702 z) for quick-GELU."""
    if gelu == "quick":
        return 1.0 / (1.0 + torch.exp(-1.702 * z))
    return 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))


def gelu_grad(z, cdf, gelu="exact"):
    """d GELU(z) / dz given ``cdf`` = gelu_gate(z): Phi(z) + z phi(z), or
    s (1 + 1.702 z (1 - s)) for quick-GELU."""
    if gelu == "quick":
        return cdf * (1.0 + 1.702 * z * (1.0 - cdf))
    return cdf + z * torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi))


def _heads(t, num_heads):  # (B, T, E) -> (B, H, T, D)
    return t.reshape(t.shape[0], t.shape[1], num_heads, -1).transpose(1, 2)


def _merge(t):  # (B, H, T, D) -> (B, T, E)
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)


def attention(q, k, v, num_heads, dtype):
    """fp32 probabilities p (B, H, Tq, Tk) and the merged output rounded to
    ``dtype``: o = round(round(p) v)."""
    qs, ks, vs = (_heads(t, num_heads) for t in (q, k, v))
    s = (qs @ ks.transpose(-1, -2)) * (1.0 / math.sqrt(qs.shape[-1]))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    return p, _merge(rnd(rnd(p, dtype) @ vs, dtype))


def attention_bwd(p, q, k, v, dom, num_heads, dtype):
    """Hand-derived attention backward: fp32 (dq, dk, dv), heads merged.
    ds = round(p (dp - sum(dp p)) scale) as the TPU kernel rounds it."""
    qs, ks, vs, do = (_heads(t, num_heads) for t in (q, k, v, dom))
    dp = do @ vs.transpose(-1, -2)
    dv = rnd(p, dtype).transpose(-1, -2) @ do
    ds = rnd(p * (dp - (dp * p).sum(-1, keepdim=True)) * (1.0 / math.sqrt(qs.shape[-1])), dtype)
    return _merge(ds @ ks), _merge(ds.transpose(-1, -2) @ qs), _merge(dv)


def tdot(a, b):
    """Contraction over every row: (..., K) x (..., N) -> (K, N) fp32."""
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


def rsum(t):
    return t.reshape(-1, t.shape[-1]).sum(0)


def r4(n: int) -> int:
    return -(-n // 4) * 4


def r8(n: int) -> int:
    return -(-n // 8) * 8


def transposed_weights(w: list[torch.Tensor]) -> list[torch.Tensor]:
    """The Dense kernels of ``STACK_WEIGHTS`` (wqkv, wo, w1, w2; stacked or
    not) transposed to (..., out, in), contiguous: the layout in which the
    encoder-layer and ViT-block kernels read the weights of their forward
    products, with the reduction axis contiguous (``csrc/mma.cuh``)."""
    return [w[i].transpose(-1, -2).contiguous() for i in (2, 4, 8, 10)]


def check_operands(x: torch.Tensor, w: list[torch.Tensor], num_heads: int, ff: int,
                   tile: int) -> None:
    """Raise ``ValueError`` for what a CUDA kernel of the training ops does
    not take: a non-bf16 dtype, a head_dim other than 32 or 64, an MLP width
    ``ff`` that is no multiple of 8, or attention state (``tile`` fp32
    values: scores, or softmax statistics) over one block's shared memory."""
    if x.dtype != torch.bfloat16:
        raise ValueError("the CUDA training kernels take bfloat16 (compute_dtype='bfloat16'); "
                         f"got {x.dtype}")
    E = x.shape[-1]
    if E not in (32 * num_heads, 64 * num_heads):
        raise ValueError(f"the CUDA training kernels take head_dim 32 or 64, got {E / num_heads:g}")
    if any(t.device != x.device for t in w):
        raise ValueError("weights and activations must be on one CUDA device")
    if ff % 8:
        raise ValueError(f"the CUDA training kernels take an MLP width that is a multiple of 8, "
                         f"got {ff}")
    if 4 * tile > MAX_SMEM:
        raise ValueError(f"{tile} fp32 attention values exceed one thread block's shared "
                         "memory: too many rows for the CUDA training kernels")
