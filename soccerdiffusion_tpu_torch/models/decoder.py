"""The denoiser (counterpart of ``soccerdiffusion_tpu/models/decoder.py``):
linear embed of the noisy (B, pred_len, joints) chunk + positional encoding
+ pre-norm cross-attending transformer decoder + linear out."""

from __future__ import annotations

import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.embeddings import PositionalEncoding
from soccerdiffusion_tpu_torch.models.layers import Linear
from soccerdiffusion_tpu_torch.models.transformer import TransformerDecoder


class DiffusionActionGenerator(nn.Module):
    def __init__(self, num_joints: int, hidden_dim: int, num_layers: int, max_seq_len: int,
                 num_heads: int = 4, fused_block: bool = False, attention_impl: str = "xla",
                 remat: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.embedding = Linear(num_joints, hidden_dim)
        self.pos = PositionalEncoding(hidden_dim, max_seq_len)
        self.decoder = TransformerDecoder(hidden_dim, num_heads, num_layers, fused_block=fused_block,
                                          attention_impl=attention_impl, remat=remat)
        self.fc_out = Linear(hidden_dim, num_joints)

    def compute_context_kv(self, context: torch.Tensor) -> list:
        """Per-layer cross-attention K/V of the static context tokens."""
        return self.decoder.compute_memory_kv(context)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                context_kv: list | None = None) -> torch.Tensor:
        """With ``context_kv`` given, ``context`` holds only the per-step
        tail tokens (the diffusion step token)."""
        x = self.pos(self.embedding(x))
        return self.fc_out(self.decoder(x, context, context_kv))
