"""Embeddings: sinusoidal position table, diffusion step token, patch conv
(counterpart of ``soccerdiffusion_tpu/models/embeddings.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.layers import Conv1d


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) table: pe[:, 0::2] = sin(pos * w_i), pe[:, 1::2] =
    cos(pos * w_i), w_i = exp(-ln(1e4) * 2i / d). Float64 on the host, cast
    to float32."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class PositionalEncoding(nn.Module):
    """Adds the fixed sinusoidal table to a (B, T, D) sequence."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(sinusoidal_table(max_len, d_model)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.table[: x.shape[1]].to(x.dtype)


class StepToken(nn.Module):
    """Diffusion-timestep token (B, 1, dim) in float32: [sin(t w), cos(t w),
    learned token (1, dim/2)] with half_dim = dim // 4 and
    w_i = exp(-i ln(1e4) / (half_dim - 1)). The caller casts it to the
    compute dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.token = nn.Parameter(torch.randn(1, dim // 2))

    def forward(self, steps: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 4
        freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=steps.device)
                          * (-math.log(10000.0) / (half_dim - 1)))
        ang = steps.float()[:, None] * freqs[None, :]
        tok = self.token.float().expand(steps.shape[0], self.dim // 2)
        emb = torch.cat([torch.sin(ang), torch.cos(ang), tok], dim=-1)
        return emb[:, None, :]


class PatchConvEmbed(nn.Module):
    """Non-overlapping 1-D patch conv over time, channels-last at the public
    function: (B, T, C) -> (B, T // patch_size, hidden_dim)."""

    def __init__(self, in_dim: int, hidden_dim: int, patch_size: int):
        super().__init__()
        self.proj = Conv1d(in_dim, hidden_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.transpose(1, 2)).transpose(1, 2)
