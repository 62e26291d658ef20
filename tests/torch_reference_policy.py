"""A PyTorch replica of the reference architecture, proprioceptive subset
(``End2EndDiffusionTransformer``: reference ml/model/model.py,
encoder/base.py, decoder.py, misc.py), built from torch primitives.

It is the same replica as ``tests/test_policy.py``'s, without JAX: it takes
the port's ``ModelConfig`` and imports nothing of the JAX package, so the
CPU tests and ``chip_smoke.py`` (on a machine without JAX) both make
reference-layout state dicts and the reference model's own outputs from
it. ``reference_state_dict`` gives the state dict under the reference's
key names (its game-state embedding is ``game_state_encoder.embedding``).
"""

from __future__ import annotations

import math

import torch
from torch import nn as tnn


class TorchPositionalEncoding(tnn.Module):
    def __init__(self, d_model, max_len):
        super().__init__()
        pe = torch.zeros(1, max_len, d_model)
        position = torch.arange(0, max_len, dtype=torch.float).unsqueeze(1)
        div_term = torch.exp(torch.arange(0, d_model, 2).float() * (-math.log(10000.0) / d_model))
        pe[0, :, 0::2] = torch.sin(position * div_term)
        pe[0, :, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x):
        return x + self.pe[:, : x.size(1)]


class TorchBaseEncoder(tnn.Module):
    """Reference BaseEncoder semantics (base.py:7-53)."""

    def __init__(self, input_dim, patch_size, hidden_dim, num_layers, num_heads, max_seq_len):
        super().__init__()
        self.embedding = tnn.Conv1d(input_dim, hidden_dim, kernel_size=patch_size, stride=patch_size)
        self.positional_encoding = TorchPositionalEncoding(hidden_dim, max_seq_len)
        self.transformer_encoder = tnn.TransformerEncoder(
            tnn.TransformerEncoderLayer(
                d_model=hidden_dim, nhead=num_heads, dim_feedforward=hidden_dim,
                batch_first=True, norm_first=True, activation="gelu", dropout=0.0,
            ),
            num_layers=num_layers,
        )

    def forward(self, x):
        x = self.embedding(x.permute(0, 2, 1)).permute(0, 2, 1)
        x = self.positional_encoding(x)
        return self.transformer_encoder(x)


class TorchStepToken(tnn.Module):
    """Reference StepToken semantics (misc.py:6-35)."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.token = tnn.Parameter(torch.randn(1, dim // 2))

    def forward(self, steps):
        half_dim = self.dim // 4
        emb = torch.exp(torch.arange(half_dim, device=steps.device) * -math.log(10000)
                        / (half_dim - 1))
        emb = steps[:, None] * emb[None, :]
        return torch.cat(
            (emb.sin(), emb.cos(), self.token.expand((steps.size(0), self.dim // 2))), dim=-1
        ).unsqueeze(1)


class TorchActionGenerator(tnn.Module):
    """Reference DiffusionActionGenerator semantics (decoder.py:6-54)."""

    def __init__(self, num_joints, hidden_dim, num_layers, num_heads, max_seq_len):
        super().__init__()
        self.embedding = tnn.Linear(num_joints, hidden_dim)
        self.positional_encoding = TorchPositionalEncoding(hidden_dim, max_seq_len)
        self.transformer_decoder = tnn.TransformerDecoder(
            tnn.TransformerDecoderLayer(
                d_model=hidden_dim, nhead=num_heads, dim_feedforward=hidden_dim,
                batch_first=True, norm_first=True, activation="gelu", dropout=0.0,
            ),
            num_layers=num_layers,
        )
        self.fc_out = tnn.Linear(hidden_dim, num_joints)

    def forward(self, x, context):
        x = self.embedding(x)
        x = self.positional_encoding(x)
        return self.fc_out(self.transformer_decoder(x, context))


class TorchReferencePolicy(tnn.Module):
    """Reference End2EndDiffusionTransformer semantics, proprioceptive subset
    (model.py:16-179), for the port's ``ModelConfig``."""

    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_dim
        self.step_encoding = TorchStepToken(h)
        self.action_history_encoder = TorchBaseEncoder(
            cfg.num_joints, cfg.encoder_patch_size, h,
            cfg.num_action_history_encoder_layers, 4, cfg.action_context_length)
        self.imu_encoder = TorchBaseEncoder(
            cfg.imu_input_dim, cfg.encoder_patch_size, h,
            cfg.num_imu_encoder_layers, 4, cfg.imu_context_length)
        self.joint_states_encoder = TorchBaseEncoder(
            cfg.num_joints, cfg.encoder_patch_size, h,
            cfg.joint_state_encoder_layers, 4, cfg.joint_state_context_length)
        self.game_state_encoder_embedding = tnn.Embedding(4, h)
        self.diffusion_action_generator = TorchActionGenerator(
            cfg.num_joints, h, cfg.num_decoder_layers, 4, cfg.trajectory_prediction_length)
        self.register_buffer("mean", torch.zeros(cfg.num_joints))
        self.register_buffer("std", torch.ones(cfg.num_joints))

    def forward(self, batch, noisy, steps):
        context = [
            self.action_history_encoder(batch["joint_command_history"]),
            self.imu_encoder(batch["rotation"]),
            self.joint_states_encoder(batch["joint_state"]),
            self.game_state_encoder_embedding(batch["game_state"]).unsqueeze(1),
        ]
        context_tensor = torch.cat(context + [self.step_encoding(steps)], dim=1)
        return self.diffusion_action_generator(noisy, context_tensor)


def reference_state_dict(model: TorchReferencePolicy) -> dict[str, torch.Tensor]:
    """The replica's state dict under the reference's key names."""
    return {k.replace("game_state_encoder_embedding", "game_state_encoder.embedding"): v
            for k, v in model.state_dict().items()}
