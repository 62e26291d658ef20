"""Pre-norm GELU transformer encoder / decoder stacks (counterpart of
``soccerdiffusion_tpu/models/transformer.py``).

  encoder layer: x += attn(LN1(x));               x += mlp(LN2(x))
  decoder layer: x += self_attn(LN1(x));
                 x += cross_attn(LN2(x), memory); x += mlp(LN3(x))

The MLP width defaults to hidden (the ViT's is 4x). GELU is exact (erf)
except where the ViT stack sets ``fused_gelu`` (``vit_fused_gelu``): its
fused blocks then run that GELU, its unfused layers quick-GELU (z *
sigmoid(1.702 z)) for "quick" and "bf16" and exact GELU for "poly".
LayerNorm eps is ``LN_EPS`` = 1e-6, flax's default (torch's 1e-5 would be
a silent mismatch).

Fused knobs route a whole stack or layer through a fused kernel on the same
parameters (so checkpoints interchange): ``TransformerEncoder(fused_stack=
True)`` (``ops/fused_encoder_stack.py``, config ``encoder_fused_stack``),
``TransformerEncoder(fused_block=True)`` (one ``ops/fused_vit_block.py``
launch per layer, config ``vit_fused_block``) and
``TransformerDecoder(fused_block=True)`` (``ops/fused_decoder_layer.py``,
config ``decoder_fused_block``). Without grad (serving) the encoder ops take
their weights packed once in the compute dtype (``packed_weights``).
``attention_impl`` (``models/attention.py``) is the attention backend of the
unfused layers; the fused ones ignore it, as in the JAX package. ``remat``
recomputes each unfused layer in the backward (``torch.utils.checkpoint``:
the ViT's ``remat_image_encoder``, the decoder's ``remat_decoder``); a fused
layer, whose op saves only its inputs, ignores it, as in the JAX package."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.models.attention import MultiHeadAttention
from soccerdiffusion_tpu_torch.models.layers import LN_EPS, LayerNorm, Linear, remat
from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import decoder_layer, layer_weights
from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import (
    encoder_layer_weights,
    encoder_stack,
    stack_weights,
)
from soccerdiffusion_tpu_torch.ops._train_math import GELUS
from soccerdiffusion_tpu_torch.ops.fused_vit_block import vit_block


def packed_weights(module: nn.Module, pack, dtype: torch.dtype) -> list[torch.Tensor]:
    """A fused op's weights. With grad enabled: ``pack()``, the float32
    masters, differentiable, for the op to cast. Without: their ``dtype``
    copy, packed once and kept on ``module`` until one of its parameters is
    replaced or updated in place (its data pointer or version counter
    moves), so a serving call does not transpose, concatenate and cast the
    weights again."""
    if torch.is_grad_enabled():
        return pack()
    key = (dtype, [(p.data_ptr(), p._version) for p in module.parameters()])
    cached = getattr(module, "_packed", None)
    if cached is None or cached[0] != key:
        cached = module._packed = (key, [t.to(dtype).contiguous() for t in pack()])
    return cached[1]


class Mlp(nn.Module):
    """linear -> GELU -> linear; ``activation`` "gelu" (exact) or
    "quick_gelu" (z * sigmoid(1.702 z))."""

    def __init__(self, hidden_dim: int, ff_dim: int, activation: str = "gelu"):
        super().__init__()
        if activation not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown Mlp activation: {activation!r}")
        self.activation = activation
        self.linear1 = Linear(hidden_dim, ff_dim)
        self.linear2 = Linear(ff_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.linear1(x)
        if self.activation == "quick_gelu":
            return self.linear2(z * torch.sigmoid(1.702 * z))
        return self.linear2(F.gelu(z, approximate="none"))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, ff_dim: int | None = None,
                 activation: str = "gelu", attention_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(hidden_dim, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads, attention_impl)
        self.mlp = Mlp(hidden_dim, ff_dim or hidden_dim, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def unfused_activation(fused_gelu: str) -> str:
    """The unfused layers' activation for a ``vit_fused_gelu``: quick-GELU
    for "quick" and "bf16", exact GELU for "exact" and "poly" (its
    approximation), as in the JAX package, so that a checkpoint serves the
    same with the fused block off."""
    return "quick_gelu" if fused_gelu in ("quick", "bf16") else "gelu"


class FusedTransformerEncoderLayer(TransformerEncoderLayer):
    """The encoder layer as one fused ViT-block launch
    (``ops/fused_vit_block.py``), on the plain layer's parameters; ``gelu``
    is "exact", "quick", "poly" or "bf16"."""

    def __init__(self, hidden_dim: int, num_heads: int, ff_dim: int | None = None,
                 gelu: str = "exact"):
        super().__init__(hidden_dim, num_heads, ff_dim, unfused_activation(gelu))
        self.gelu = gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = packed_weights(self, lambda: encoder_layer_weights(self), x.dtype)
        return vit_block(x, w, self.num_heads, self.gelu)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, attention_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads, attention_impl)
        self.cross_attn = MultiHeadAttention(hidden_dim, num_heads, attention_impl)
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
    memory K/V itself, which is what it saves in training. Like every fused
    layer it ignores ``attention_impl``: its plain math attends with
    ``plain_attention``, as the JAX layer's with ``xla_attention``."""

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv=None) -> torch.Tensor:
        if memory_kv is not None or memory is None:
            return super().forward(x, memory, memory_kv)
        return decoder_layer(x, memory.to(x.dtype), layer_weights(self), self.num_heads)


class TransformerEncoder(nn.Module):
    """``fused_stack=True`` runs all layers as one fused op with a
    hand-written backward (exact GELU only); ``fused_block=True`` runs each
    layer as one fused ViT block (``fused_stack`` wins where both are set,
    as in the JAX package). ``fused_gelu`` is the JAX package's
    ``vit_fused_gelu``: "exact", "quick", "poly" or "bf16" on the fused
    block; the unfused layers run quick-GELU for "quick" and "bf16" and
    exact GELU for "exact" and "poly" (``unfused_activation``). ``attention_impl``
    (``models/attention.py``) is the unfused layers' attention backend; the
    fused stack and blocks ignore it, as in the JAX package."""

    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int,
                 ff_dim: int | None = None, fused_stack: bool = False, fused_block: bool = False,
                 fused_gelu: str = "exact", attention_impl: str = "xla", remat: bool = False):
        super().__init__()
        if fused_stack and fused_gelu != "exact":
            raise ValueError(f"fused_stack computes exact GELU; fused_gelu={fused_gelu!r} is "
                             "not supported there")
        if fused_gelu not in GELUS:
            raise ValueError(f"unknown vit_fused_gelu: {fused_gelu!r}")
        self.num_heads, self.fused_stack = num_heads, fused_stack
        self.remat = remat and not (fused_stack or fused_block)
        if fused_block and not fused_stack:
            make = lambda: FusedTransformerEncoderLayer(hidden_dim, num_heads, ff_dim, fused_gelu)
        else:
            make = lambda: TransformerEncoderLayer(hidden_dim, num_heads, ff_dim,
                                                   unfused_activation(fused_gelu), attention_impl)
        self.layers = nn.ModuleList([make() for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_stack:
            w = packed_weights(self, lambda: stack_weights(self.layers), x.dtype)
            return encoder_stack(x, w, self.num_heads)
        for layer in self.layers:
            x = remat(layer, x) if self.remat else layer(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int,
                 fused_block: bool = False, attention_impl: str = "xla", remat: bool = False):
        super().__init__()
        self.remat = remat and not fused_block
        if fused_block:
            make = lambda: FusedTransformerDecoderLayer(hidden_dim, num_heads)
        else:
            make = lambda: TransformerDecoderLayer(hidden_dim, num_heads, attention_impl)
        self.layers = nn.ModuleList([make() for _ in range(num_layers)])

    def compute_memory_kv(self, memory: torch.Tensor) -> list:
        return [layer.compute_memory_kv(memory) for layer in self.layers]

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                memory_kv: list | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            kv = memory_kv[i] if memory_kv is not None else None
            x = remat(layer, x, memory, kv) if self.remat else layer(x, memory, kv)
        return x
