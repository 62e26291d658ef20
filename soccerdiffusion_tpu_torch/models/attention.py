"""Multi-head attention with cacheable K/V (counterpart of
``soccerdiffusion_tpu/models/attention.py``, its "xla" backend).

Scores, softmax and the value sum accumulate in float32; probabilities and
the output are rounded to the compute dtype, as the JAX package does."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.layers import Linear


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, T, H, D) tensors."""
    dtype = q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention when no K/V input is given, cross-attention otherwise;
    no masking (the chunk is denoised jointly)."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        if hidden_dim % num_heads != 0:
            raise ValueError("hidden_dim must be divisible by num_heads")
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.q_proj = Linear(hidden_dim, hidden_dim)
        self.k_proj = Linear(hidden_dim, hidden_dim)
        self.v_proj = Linear(hidden_dim, hidden_dim)
        self.out_proj = Linear(hidden_dim, hidden_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, -1)

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
        out = plain_attention(q, k, v)
        return self.out_proj(out.reshape(x_q.shape[0], x_q.shape[1], self.hidden_dim))
