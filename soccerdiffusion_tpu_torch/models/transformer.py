"""Pre-norm exact-GELU transformer encoder / decoder stacks (counterpart of
``soccerdiffusion_tpu/models/transformer.py``).

  encoder layer: x += attn(LN1(x));               x += mlp(LN2(x))
  decoder layer: x += self_attn(LN1(x));
                 x += cross_attn(LN2(x), memory); x += mlp(LN3(x))

MLP width equals hidden. LayerNorm eps is ``LN_EPS`` = 1e-6, flax's
default (torch's 1e-5 would be a silent mismatch).

Two training knobs route a whole stack or layer through a fused kernel
with a hand-written backward, on the same parameters (so checkpoints
interchange): ``TransformerEncoder(fused_stack=True)``
(``ops/fused_encoder_stack.py``, config ``encoder_fused_stack``) and
``TransformerDecoder(fused_block=True)`` (``ops/fused_decoder_layer.py``,
config ``decoder_fused_block``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.models.attention import MultiHeadAttention
from soccerdiffusion_tpu_torch.models.layers import LN_EPS, LayerNorm, Linear
from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import decoder_layer, layer_weights
from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import encoder_stack, stack_weights


class Mlp(nn.Module):
    def __init__(self, hidden_dim: int, ff_dim: int):
        super().__init__()
        self.linear1 = Linear(hidden_dim, ff_dim)
        self.linear2 = Linear(ff_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x), approximate="none"))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.norm1 = LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(hidden_dim, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads)
        self.mlp = Mlp(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads)
        self.cross_attn = MultiHeadAttention(hidden_dim, num_heads)
        self.mlp = Mlp(hidden_dim, hidden_dim)
        self.norm1 = LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm3 = LayerNorm(hidden_dim, eps=LN_EPS)

    def compute_memory_kv(self, memory: torch.Tensor):
        """Cross-attention K/V of the memory: it enters un-normed, so its
        projections depend on the memory alone and can be cached."""
        return self.cross_attn.compute_kv(memory)

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv=None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), memory, precomputed_kv=memory_kv)
        return x + self.mlp(self.norm3(x))


class FusedTransformerDecoderLayer(TransformerDecoderLayer):
    """The decoder layer through the fused fwd+bwd decoder-layer op, on the
    plain layer's parameters. With cached ``memory_kv`` or without a memory
    it runs the plain math, as the JAX layer does: the kernel projects the
    memory K/V itself, which is what it saves in training."""

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv=None) -> torch.Tensor:
        if memory_kv is not None or memory is None:
            return super().forward(x, memory, memory_kv)
        return decoder_layer(x, memory.to(x.dtype), layer_weights(self), self.num_heads)


class TransformerEncoder(nn.Module):
    """``fused_stack=True`` runs all layers as one fused op with a
    hand-written backward."""

    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int,
                 fused_stack: bool = False):
        super().__init__()
        self.num_heads, self.fused_stack = num_heads, fused_stack
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(hidden_dim, num_heads) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_stack:
            return encoder_stack(x, stack_weights(self.layers), self.num_heads)
        for layer in self.layers:
            x = layer(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int,
                 fused_block: bool = False):
        super().__init__()
        layer_cls = FusedTransformerDecoderLayer if fused_block else TransformerDecoderLayer
        self.layers = nn.ModuleList(
            [layer_cls(hidden_dim, num_heads) for _ in range(num_layers)])

    def compute_memory_kv(self, memory: torch.Tensor) -> list:
        return [layer.compute_memory_kv(memory) for layer in self.layers]

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv: list | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, memory, memory_kv[i] if memory_kv is not None else None)
        return x
