"""Image encoders (counterpart of ``soccerdiffusion_tpu/models/vision.py``):
the ViT image encoder and the image *sequence* encoder. The ResNet and Swin
encoders are not ported yet (ROADMAP.md).

Images are channels-last (N, H, W, 3) at the public functions, as in the
JAX package, or pre-patchified (N, patches, P*P*3) (``data/pipeline.
patchify_frames``). Normalised float frames compute in their own dtype (the
policy casts them to the compute dtype); raw uint8 frames come with a
``valid`` mask and the ViT folds their normalisation into its patch
embedding, computing in ``ViTImageEncoder.dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from soccerdiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from soccerdiffusion_tpu_torch.data.pipeline import patchify_frames
from soccerdiffusion_tpu_torch.models.embeddings import PositionalEncoding
from soccerdiffusion_tpu_torch.models.encoders import SequenceEncoder
from soccerdiffusion_tpu_torch.models.layers import LN_EPS, LayerNorm, Linear
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder


class ViTImageEncoder(nn.Module):
    """Patchified pre-norm transformer: reshape/transpose patchify -> patch
    embed (one matmul; params ``patch_kernel`` (P*P*C, width) and
    ``patch_bias``) -> + sinusoidal positions -> ``depth`` blocks (ff = 4 x
    width, 4 heads) -> mean pool -> LayerNorm -> Dense(hidden).
    (N, H, W, C) frames, or pre-patchified (N, patches, P*P*C), -> (N, hidden).

    With ``valid`` (N,) the frames are RAW uint8: the [0, 1] scale and the
    ImageNet normalisation are folded into the patch embedding (the kernel
    rows scaled by 1 / (255 std_c), the bias less tile(mean / std) @ kernel
    in float32), the tokens computed in ``dtype``, and invalid frames reset
    to the bias, the embedding of a zero image. The fold is differentiable:
    the gradient reaches ``patch_kernel`` and ``patch_bias`` through it."""

    num_heads = 4

    def __init__(self, hidden_dim: int, image_resolution: int, patch_size: int = 16,
                 width: int = 192, depth: int = 6, fused_block: bool = False,
                 fused_gelu: str = "exact", dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        num_patches = (image_resolution // patch_size) ** 2
        self.patch_kernel = nn.Parameter(torch.zeros(patch_size * patch_size * 3, width))  # RGB
        self.patch_bias = nn.Parameter(torch.zeros(width))
        self.pos = PositionalEncoding(width, num_patches)
        self.blocks = TransformerEncoder(width, self.num_heads, depth, ff_dim=4 * width,
                                         fused_block=fused_block, fused_gelu=fused_gelu,
                                         attention_impl=attention_impl)
        self.norm = LayerNorm(width, eps=LN_EPS)
        self.fc = Linear(width, hidden_dim)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> (N, patches, P*P*C) (``data/pipeline.patchify_frames``)."""
        return patchify_frames(x, self.patch_size)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        patches = x if x.ndim == 3 else self.patchify(x)
        if valid is not None:
            reps = self.patch_kernel.shape[0] // 3  # P*P pixels of 3 channels
            mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
            std = torch.as_tensor(IMAGENET_STD, device=x.device)
            k_fold = (self.patch_kernel * (1.0 / (255.0 * std)).repeat(reps)[:, None]).to(self.dtype)
            b_fold = self.patch_bias - (mean / std).repeat(reps) @ self.patch_kernel
            tokens = (patches.to(self.dtype) @ k_fold).float() + b_fold
            gate = valid.float()[:, None, None]
            x = (self.patch_bias + gate * (tokens - self.patch_bias)).to(self.dtype)
        else:
            tokens = patches @ self.patch_kernel.to(x.dtype)
            x = (tokens + self.patch_bias).to(x.dtype)
        x = self.blocks(self.pos(x)).mean(dim=1)
        return self.fc(self.norm(x))


def make_image_encoder(encoder_type: str, hidden_dim: int, image_resolution: int,
                       vit_geometry: tuple = (16, 192, 6), vit_fused_block: bool = False,
                       vit_fused_gelu: str = "exact", dtype: torch.dtype = torch.float32,
                       attention_impl: str = "xla") -> nn.Module:
    """The per-frame encoder of ``encoder_type``: "vit" only so far."""
    if encoder_type == "vit":
        patch, width, depth = vit_geometry
        return ViTImageEncoder(hidden_dim, image_resolution, patch_size=patch, width=width,
                               depth=depth, fused_block=vit_fused_block,
                               fused_gelu=vit_fused_gelu, dtype=dtype,
                               attention_impl=attention_impl)
    if encoder_type in ("resnet18", "resnet50", "swin_transformer_tiny", "swin_transformer_small"):
        raise NotImplementedError(f"image_encoder_type={encoder_type!r} is not ported yet "
                                  "(see ROADMAP.md, 'H100 port')")
    raise ValueError(f"unknown image encoder type: {encoder_type}")


class ImageSequenceEncoder(nn.Module):
    """(B, T, H, W, 3) frames, or pre-patchified (B, T, patches, P*P*3), ->
    (B, T, hidden) context tokens: each frame through the per-frame encoder,
    then (``sequence_encoder_type="transformer"``) a patch-1, 8-head encoder
    stack across the T frame tokens. With ``valid`` (B, T) the frames are
    raw uint8 and the ViT folds their normalisation.

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
                 vit_fused_gelu: str = "exact", seq_fused_stack: bool = False,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "xla"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.image_encoder = make_image_encoder(encoder_type, hidden_dim, image_resolution,
                                                vit_geometry, vit_fused_block, vit_fused_gelu,
                                                dtype, attention_impl)
        if sequence_encoder_type == "transformer":
            self.seq = SequenceEncoder(hidden_dim, hidden_dim, 1, num_layers, 8, max_seq_len,
                                       seq_fused_stack, attention_impl)
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
            b, t = x.shape[:2]
            tokens = self.image_encoder(x.reshape(b * t, *x.shape[2:]),
                                        None if valid is None else valid.reshape(b * t))
            tokens = tokens.reshape(b, t, self.hidden_dim)
            if mode == "frames":
                return tokens
        return tokens if self.seq is None else self.seq(tokens)
