"""Pre-norm exact-GELU transformer encoder / decoder stacks (counterpart of
the unfused path of ``soccerdiffusion_tpu/models/transformer.py``).

  encoder layer: x += attn(LN1(x));               x += mlp(LN2(x))
  decoder layer: x += self_attn(LN1(x));
                 x += cross_attn(LN2(x), memory); x += mlp(LN3(x))

MLP width equals hidden. LayerNorm eps is 1e-6, flax's default (torch's
1e-5 would be a silent mismatch)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.models.attention import MultiHeadAttention

LN_EPS = 1e-6


class Mlp(nn.Module):
    def __init__(self, hidden_dim: int, ff_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(hidden_dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x), approximate="none"))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads)
        self.mlp = Mlp(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads)
        self.cross_attn = MultiHeadAttention(hidden_dim, num_heads)
        self.mlp = Mlp(hidden_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def compute_memory_kv(self, memory: torch.Tensor):
        """Cross-attention K/V of the memory: it enters un-normed, so its
        projections depend on the memory alone and can be cached."""
        return self.cross_attn.compute_kv(memory)

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv=None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), memory, precomputed_kv=memory_kv)
        return x + self.mlp(self.norm3(x))


class TransformerEncoder(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(hidden_dim, num_heads) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerDecoderLayer(hidden_dim, num_heads) for _ in range(num_layers)])

    def compute_memory_kv(self, memory: torch.Tensor) -> list:
        return [layer.compute_memory_kv(memory) for layer in self.layers]

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv: list | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, memory, memory_kv[i] if memory_kv is not None else None)
        return x
