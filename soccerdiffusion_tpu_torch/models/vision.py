"""Image encoders (counterpart of ``soccerdiffusion_tpu/models/vision.py``):
the ViT image encoder and the image *sequence* encoder. The ResNet and Swin
encoders are not ported yet (ROADMAP.md).

Images are channels-last (N, H, W, 3) at the public functions, as in the
JAX package. Modules compute in their input's dtype; the policy casts frames
and cached tokens to the compute dtype at its boundary.
"""

from __future__ import annotations

import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.embeddings import PositionalEncoding
from soccerdiffusion_tpu_torch.models.encoders import SequenceEncoder
from soccerdiffusion_tpu_torch.models.layers import LN_EPS, LayerNorm, Linear
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder

_RAW_U8 = ("raw uint8 frames with a `valid` mask (the packed training data's folded "
           "normalisation) come with the flagship training slice (see ROADMAP.md, 'H100 port')")


class ViTImageEncoder(nn.Module):
    """Patchified pre-norm transformer: reshape/transpose patchify -> patch
    embed (one matmul; params ``patch_kernel`` (P*P*C, width) and
    ``patch_bias``) -> + sinusoidal positions -> ``depth`` blocks (ff = 4 x
    width, 4 heads) -> mean pool -> LayerNorm -> Dense(hidden).
    (N, H, W, C) frames, or pre-patchified (N, patches, P*P*C), -> (N, hidden)."""

    num_heads = 4

    def __init__(self, hidden_dim: int, image_resolution: int, patch_size: int = 16,
                 width: int = 192, depth: int = 6, fused_block: bool = False,
                 fused_gelu: str = "exact"):
        super().__init__()
        self.patch_size = patch_size
        num_patches = (image_resolution // patch_size) ** 2
        self.patch_kernel = nn.Parameter(torch.zeros(patch_size * patch_size * 3, width))  # RGB
        self.patch_bias = nn.Parameter(torch.zeros(width))
        self.pos = PositionalEncoding(width, num_patches)
        self.blocks = TransformerEncoder(width, self.num_heads, depth, ff_dim=4 * width,
                                         fused_block=fused_block, fused_gelu=fused_gelu)
        self.norm = LayerNorm(width, eps=LN_EPS)
        self.fc = Linear(width, hidden_dim)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> (N, patches, P*P*C), patches in row-major order and
        each patch's pixels row-major with channels last."""
        n, h, w, c = x.shape
        p = self.patch_size
        x = x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, (h // p) * (w // p), p * p * c)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        if valid is not None:
            raise NotImplementedError(_RAW_U8)
        patches = x if x.ndim == 3 else self.patchify(x)
        tokens = patches @ self.patch_kernel.to(x.dtype)
        x = self.pos((tokens + self.patch_bias).to(x.dtype))
        x = self.blocks(x).mean(dim=1)
        return self.fc(self.norm(x))


def make_image_encoder(encoder_type: str, hidden_dim: int, image_resolution: int,
                       vit_geometry: tuple = (16, 192, 6), vit_fused_block: bool = False,
                       vit_fused_gelu: str = "exact") -> nn.Module:
    """The per-frame encoder of ``encoder_type``: "vit" only so far."""
    if encoder_type == "vit":
        patch, width, depth = vit_geometry
        return ViTImageEncoder(hidden_dim, image_resolution, patch_size=patch, width=width,
                               depth=depth, fused_block=vit_fused_block,
                               fused_gelu=vit_fused_gelu)
    if encoder_type in ("resnet18", "resnet50", "swin_transformer_tiny", "swin_transformer_small"):
        raise NotImplementedError(f"image_encoder_type={encoder_type!r} is not ported yet "
                                  "(see ROADMAP.md, 'H100 port')")
    raise ValueError(f"unknown image encoder type: {encoder_type}")


class ImageSequenceEncoder(nn.Module):
    """(B, T, H, W, 3) frames -> (B, T, hidden) context tokens: each frame
    through the per-frame encoder, then (``sequence_encoder_type=
    "transformer"``) a patch-1, 8-head encoder stack across the T frame
    tokens.

    ``mode`` splits the pipeline for the serving-side token cache:
      * "full":     frames -> per-frame tokens -> sequence encoder
      * "frames":   frames -> per-frame tokens (B, T, hidden) only
      * "sequence": ``x`` is the (B, T, hidden) token buffer; only the
                    sequence encoder runs.
    ``frames |> sequence`` equals ``full``: a frame's tokens depend on that
    frame alone."""

    def __init__(self, hidden_dim: int, encoder_type: str, sequence_encoder_type: str,
                 num_layers: int, max_seq_len: int, image_resolution: int,
                 vit_geometry: tuple = (16, 192, 6), vit_fused_block: bool = False,
                 vit_fused_gelu: str = "exact", seq_fused_stack: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.image_encoder = make_image_encoder(encoder_type, hidden_dim, image_resolution,
                                                vit_geometry, vit_fused_block, vit_fused_gelu)
        if sequence_encoder_type == "transformer":
            self.seq = SequenceEncoder(hidden_dim, hidden_dim, 1, num_layers, 8, max_seq_len,
                                       seq_fused_stack)
        elif sequence_encoder_type == "none":
            self.seq = None
        else:
            raise ValueError(f"unknown sequence encoder type {sequence_encoder_type!r}")

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None,
                mode: str = "full") -> torch.Tensor:
        if mode not in ("full", "frames", "sequence"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "sequence":
            tokens = x
        else:
            if valid is not None:
                raise NotImplementedError(_RAW_U8)
            b, t = x.shape[:2]
            tokens = self.image_encoder(x.reshape(b * t, *x.shape[2:]))
            tokens = tokens.reshape(b, t, self.hidden_dim)
            if mode == "frames":
                return tokens
        return tokens if self.seq is None else self.seq(tokens)
