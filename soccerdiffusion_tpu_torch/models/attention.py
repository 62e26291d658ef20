"""Multi-head attention with cacheable K/V and a pluggable backend
(counterpart of ``soccerdiffusion_tpu/models/attention.py``).

The backend ``f(q, k, v) -> o`` over (B, T, H, D) tensors is chosen by
``attention_impl`` (``resolve_attention_fn``):

  * "xla":    ``plain_attention``: scores, softmax and the value sum
              accumulate in float32; probabilities and the output are
              rounded to the compute dtype, as the JAX package's XLA path.
  * "pallas": ``ops/flash_attention.py``, the hand-written flash kernel
              (fp32 probabilities, never rounded; the TPU kernel's numerics).
  * "auto":   the flash kernel for CUDA tensors with Tq * Tk >= 256^2, else
              ``plain_attention`` (the JAX package's ``flash_attention_auto``
              with the TPU read as the card). No shipped shape reaches the
              threshold (the largest is 100 x 100).
  * "ring":   ``parallel/ring_attention.auto_ring_attention``: ring or
              head-sharded attention over the ambient mesh's ``seq`` axis
              (``parallel/mesh.use_mesh``), plain attention without one.

Under tensor parallelism (``parallel/tensor_parallel.py``) the projections
hold the rank's heads only: the layer splits and merges heads at the width
its projections give, not at ``hidden_dim``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.layers import Linear
from soccerdiffusion_tpu_torch.ops.flash_attention import flash_attention
from soccerdiffusion_tpu_torch.parallel.ring_attention import auto_ring_attention

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

# "auto" takes the flash kernel from this many scores per (batch, head) on;
# the JAX package's threshold (flash_attention.py:324), not tuned for the card
AUTO_FLASH_SCORES = 256 * 256


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, T, H, D) tensors."""
    dtype = q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def auto_takes_flash(device_type: str, tq: int, tk: int) -> bool:
    """Whether "auto" runs the flash kernel for a (Tq, Tk) problem on a device."""
    return device_type == "cuda" and tq * tk >= AUTO_FLASH_SCORES


def auto_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The "auto" backend: shape- and device-aware dispatch."""
    if auto_takes_flash(q.device.type, q.shape[1], k.shape[1]):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v)


def resolve_attention_fn(impl: str) -> AttentionFn:
    """The backend function of an ``attention_impl`` name."""
    if impl == "xla":
        return plain_attention
    if impl == "pallas":
        return flash_attention
    if impl == "auto":
        return auto_attention
    if impl == "ring":
        return auto_ring_attention
    raise ValueError(f"unknown attention impl: {impl!r}")


class MultiHeadAttention(nn.Module):
    """Self-attention when no K/V input is given, cross-attention otherwise;
    no masking (the chunk is denoised jointly)."""

    def __init__(self, hidden_dim: int, num_heads: int, attention_impl: str = "xla"):
        super().__init__()
        if hidden_dim % num_heads != 0:
            raise ValueError("hidden_dim must be divisible by num_heads")
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.attend = resolve_attention_fn(attention_impl)
        self.q_proj = Linear(hidden_dim, hidden_dim)
        self.k_proj = Linear(hidden_dim, hidden_dim)
        self.v_proj = Linear(hidden_dim, hidden_dim)
        self.out_proj = Linear(hidden_dim, hidden_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        # explicit head_dim: a memory of 0 tokens (the decoder-only tier) reshapes too
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, x.shape[-1] // self.num_heads)

    def compute_kv(self, x_kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Project memory to (k, v), each (B, S, H, D)."""
        return self._split(self.k_proj(x_kv)), self._split(self.v_proj(x_kv))

    def forward(self, x_q: torch.Tensor, x_kv: Optional[torch.Tensor] = None,
                precomputed_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        q = self._split(self.q_proj(x_q))
        if precomputed_kv is not None:
            k, v = precomputed_kv
            if x_kv is not None:
                # cached static part + freshly projected tail (the step token)
                k_tail, v_tail = self.compute_kv(x_kv)
                k = torch.cat([k, k_tail.expand(k.shape[0], -1, -1, -1)], dim=1)
                v = torch.cat([v, v_tail.expand(v.shape[0], -1, -1, -1)], dim=1)
        else:
            k, v = self.compute_kv(x_q if x_kv is None else x_kv)
        out = self.attend(q, k, v)
        return self.out_proj(out.reshape(x_q.shape[0], x_q.shape[1], out.shape[2] * out.shape[3]))
