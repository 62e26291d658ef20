"""Flash attention with a hand-written backward (``csrc/flash_attention.cu``),
the attention backend of ``attention_impl="pallas"`` (and of ``"auto"`` on
long sequences, ``models/attention.py``).

Counterpart of ``soccerdiffusion_tpu/ops/flash_attention.py``
(``flash_attention``): softmax(q k^T / sqrt(D)) v over (B, T, H, D)
tensors, Tq and Tk free (cross-attention), no mask. Its numerics are the
TPU kernel's, which differ from ``plain_attention`` in bf16: fp32 scores
times the scale, fp32 probabilities that are never rounded, an fp32 value
sum divided by the denominator after the product, the output in q's dtype.

``FlashAttention`` is the ``torch.autograd.Function``; it saves q, k, v, o
and the fp32 row log-sum-exp (B, H, Tq). The plain versions
(``plain_forward``, ``plain_backward``) are the spec and run on CPU
tensors; a CUDA tensor launches the kernels (fp32 or bf16, head_dim 1 to
128) or raises. The kernel library dispatches by dtype, never on a
failure: bf16 operands (every model path, which computes in bf16) run the
tensor-core instances (mma.sync; the fp32 probabilities multiplied as two
bf16 halves), float32 operands the scalar fp32 instances. ``FlashAttention.launches`` / ``.backward_launches`` count
kernel launches (a backward is two kernels, counted once).
"""

from __future__ import annotations

import math

import torch

from soccerdiffusion_tpu_torch.ops import _build

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` for operands outside the op's contract."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention takes q (B, Tq, H, D) and k, v (B, Tk, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 operands of one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM or min(q.shape[:3]) < 1 or k.shape[1] < 1:
        raise ValueError(f"flash_attention takes head_dim 1 to {MAX_HEAD_DIM} and nonempty "
                         f"operands; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, (B, Tq, H, D) in q's dtype; differentiable."""
    return FlashAttention.apply(q, k, v)


# ------------------------------------------------------- plain versions

def plain_forward(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function (``_attn_kernel``'s math): o in q's
    dtype and the fp32 row log-sum-exp (B, H, Tq)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / denom.transpose(1, 2)
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def plain_flash_attention(q, k, v) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, on any device."""
    return plain_forward(q, k, v)[0]


def plain_backward(q, k, v, o, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function (``_attn_bwd_kernel``'s formulas, the
    probabilities from the saved log-sum-exp, delta = rowsum(do * o) in fp32
    with the saved o): dq, dk, dv in the operands' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = (dof * o.float()).sum(dim=-1).transpose(1, 2)  # (B, H, Tq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------- CUDA kernels

def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride along D (the kernels read the rest by stride)."""
    if t.numel() >= 2 ** 31:
        raise ValueError(f"flash_attention: {tuple(t.shape)} has 2^31 elements or more")
    return t if t.stride(-1) == 1 else t.contiguous()


def _strides(*tensors) -> list[int]:
    return [s for t in tensors for s in t.stride()[:3]]


def forward_kernel(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: o (q's dtype) and lse (B, H, Tq) fp32."""
    check_operands(q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    B, Tq, H, D = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = _build.library().sd_flash_attention_fwd(
        _build.pointers(q, k, v, o, lse),
        _build.ints(B, H, Tq, k.shape[1], D, _DTYPE_CODES[q.dtype], *_strides(q, k, v, o)),
        _build.stream(q.device))
    _build.check("sd_flash_attention_fwd", err)
    FlashAttention.launches += 1
    return o, lse


def backward_kernel(q, k, v, o, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on CUDA tensors (dq with delta, then dk / dv):
    dq, dk, dv in the operands' dtype."""
    check_operands(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape or o.dtype != q.dtype \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} {do.dtype}, o "
                         f"{tuple(o.shape)} {o.dtype}, lse {tuple(lse.shape)} {lse.dtype} do not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    q, k, v, o, do = _rows(q), _rows(k), _rows(v), _rows(o), _rows(do)
    lse = lse.contiguous()
    B, Tq, H, D = q.shape
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = _build.library().sd_flash_attention_bwd(
        _build.pointers(q, k, v, o, do, dq, dk, dv, lse, delta),
        _build.ints(B, H, Tq, k.shape[1], D, _DTYPE_CODES[q.dtype],
                    *_strides(q, k, v, o, do, dq, dk, dv)),
        _build.stream(q.device))
    _build.check("sd_flash_attention_bwd", err)
    FlashAttention.backward_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(q, k, v) -> o, the kernels on CUDA tensors, the plain versions on CPU ones."""

    launches = 0
    backward_launches = 0

    @staticmethod
    def forward(ctx, q, k, v):
        check_operands(q, k, v)
        o, lse = forward_kernel(q, k, v) if q.is_cuda else plain_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda:
            return backward_kernel(q, k, v, o, lse, do)
        return plain_backward(q, k, v, o, lse, do)
