"""Modality context encoders (counterpart of
``soccerdiffusion_tpu/models/encoders.py``): patch-conv embed -> sinusoidal
posenc -> pre-norm exact-GELU transformer encoder; the game state is one
learned embedding token."""

from __future__ import annotations

import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.embeddings import PatchConvEmbed, PositionalEncoding
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder

# {PLAYING, POSITIONING, STOPPED, UNKNOWN}
NUM_ROBOT_STATES = 4


class SequenceEncoder(nn.Module):
    """(B, T, input_dim) -> (B, T // patch_size, hidden_dim) context tokens.
    ``fused_stack`` runs the stack as one fused op, ``fused_block`` each
    layer as one fused ViT block (exact GELU; the config's
    ``encoder_fused_block``); the stack wins where both are set."""

    def __init__(self, input_dim: int, hidden_dim: int, patch_size: int, num_layers: int,
                 num_heads: int, max_seq_len: int, fused_stack: bool = False,
                 attention_impl: str = "xla", fused_block: bool = False):
        super().__init__()
        self.embedding = PatchConvEmbed(input_dim, hidden_dim, patch_size)
        self.pos = PositionalEncoding(hidden_dim, max_seq_len)
        self.encoder = TransformerEncoder(hidden_dim, num_heads, num_layers, fused_stack=fused_stack,
                                          fused_block=fused_block, attention_impl=attention_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.pos(self.embedding(x)))


class JointEncoder(nn.Module):
    """Encodes joint-angle sequences (action history or joint states)."""

    num_heads = 4

    def __init__(self, num_joints: int, hidden_dim: int, patch_size: int, num_layers: int,
                 max_seq_len: int, fused_stack: bool = False, attention_impl: str = "xla",
                 fused_block: bool = False):
        super().__init__()
        self.num_joints = num_joints
        self.seq = SequenceEncoder(num_joints, hidden_dim, patch_size, num_layers,
                                   self.num_heads, max_seq_len, fused_stack, attention_impl,
                                   fused_block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.num_joints:
            raise ValueError(f"expected {self.num_joints} joints, got {x.shape[-1]}")
        return self.seq(x)


class IMUEncoder(nn.Module):
    """Encodes orientation sequences, input dim 4 (quaternion) or 5 (axis + sin/cos)."""

    num_heads = 4

    def __init__(self, input_dim: int, hidden_dim: int, patch_size: int, num_layers: int,
                 max_seq_len: int, fused_stack: bool = False, attention_impl: str = "xla",
                 fused_block: bool = False):
        super().__init__()
        self.input_dim = input_dim
        self.seq = SequenceEncoder(input_dim, hidden_dim, patch_size, num_layers,
                                   self.num_heads, max_seq_len, fused_stack, attention_impl,
                                   fused_block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.input_dim:
            raise ValueError(f"expected imu dim {self.input_dim}, got {x.shape[-1]}")
        return self.seq(x)


class GameStateEncoder(nn.Module):
    """(B,) int robot-state ids -> (B, 1, hidden_dim) learned token, in the
    parameters' dtype (the caller casts it to the compute dtype)."""

    def __init__(self, hidden_dim: int, num_states: int = NUM_ROBOT_STATES):
        super().__init__()
        self.embedding = nn.Embedding(num_states, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding(x.long())[:, None, :]
