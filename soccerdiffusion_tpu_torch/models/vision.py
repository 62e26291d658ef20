"""Image encoders (counterpart of ``soccerdiffusion_tpu/models/vision.py``):
the ResNet18 / ResNet50 and ViT image encoders, the factory that also
builds the Swin encoders (``models/swin.py``), and the image *sequence*
encoder.

Images are channels-last (N, H, W, 3) at the public functions, as in the
JAX package, or pre-patchified (N, patches, P*P*3) for the ViT
(``data/pipeline.patchify_frames``). Normalised float frames compute in the
encoder's dtype (the policy casts them to the compute dtype); raw uint8
frames come with a ``valid`` mask: the ViT folds their normalisation into
its patch embedding, the other encoders get them normalised by
``data/pipeline.device_normalize_images``.

The ResNets keep BatchNorm running statistics (``models/layers.BatchNorm``,
flax's ``batch_stats``): they normalise with the batch's statistics and
update the running ones in ``module.train()`` mode, and use the running
ones in ``eval()`` mode. ``remat_image_encoder``: True recomputes the
per-frame ResNet / Swin forward in the backward, keeping only the input of
each region (the ResNet's stem and residual blocks, Swin's blocks and
merges; the ViT's unfused blocks); "conv_only" (ResNets, the same regions)
keeps every conv output and the BatchNorm batch statistics and recomputes
only the normalise / ReLU chain. A block is a region of its own because torch's non-reentrant checkpoint
recomputes a region whole and holds all its intermediates until the
backward has used them: one region over the whole trunk would hold every
recomputed activation at once and save no peak memory (measured on an
H100, PERF.md). No remat mode changes a number, and a recompute leaves the
running statistics alone.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from soccerdiffusion_tpu_torch.config import VALID_IMAGE_ENCODERS, check_remat_image_encoder
from soccerdiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from soccerdiffusion_tpu_torch.data.pipeline import device_normalize_images, patchify_frames
from soccerdiffusion_tpu_torch.models.embeddings import PositionalEncoding
from soccerdiffusion_tpu_torch.models.encoders import SequenceEncoder
from soccerdiffusion_tpu_torch.models.layers import (
    LN_EPS,
    BatchNorm,
    Conv2d,
    LayerNorm,
    Linear,
    remat,
)
from soccerdiffusion_tpu_torch.models.swin import SwinImageEncoder
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder

# what remat_image_encoder="conv_only" keeps for the backward: every conv's
# output and the BatchNorm batch statistics (one var_mean call each)
_CONV_ONLY_SAVES = (torch.ops.aten.convolution.default, torch.ops.aten.var_mean.correction)


def _conv_only_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _CONV_ONLY_SAVES else \
        CheckpointPolicy.PREFER_RECOMPUTE


conv_only_context = functools.partial(create_selective_checkpoint_contexts, _conv_only_policy)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0):
    return (Conv2d(cin, cout, k, stride, ((pad, pad), (pad, pad)), bias=False),
            BatchNorm(cout))


class BasicBlock(nn.Module):
    """ResNet-18/34 residual block: 3x3 conv, BN, ReLU, 3x3 conv, BN, + the
    skip (a strided 1x1 conv + BN where the shape changes), ReLU."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, filters, 3, stride, 1)
        self.conv2, self.bn2 = _conv_bn(filters, filters, 3, 1, 1)
        if stride != 1 or cin != filters:
            self.downsample_conv, self.downsample_bn = _conv_bn(cin, filters, 1, stride)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """ResNet-50 bottleneck block: 1x1 -> 3x3 (strided) -> 1x1 at 4x the
    width, each with BN, + the skip, ReLU."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, filters, 1)
        self.conv2, self.bn2 = _conv_bn(filters, filters, 3, stride, 1)
        self.conv3, self.bn3 = _conv_bn(filters, 4 * filters, 1)
        if stride != 1 or cin != 4 * filters:
            self.downsample_conv, self.downsample_bn = _conv_bn(cin, 4 * filters, 1, stride)
        self.out_channels = 4 * filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


def resnet_map_size(image_resolution: int) -> int:
    """Side of the ResNet's final feature map: five halvings, each rounding
    up (the stem conv, the max pool, three strided stages)."""
    n = image_resolution
    for _ in range(5):
        n = -(-n // 2)
    return n


class ResNetImageEncoder(nn.Module):
    """torchvision's ResNet trunk, channels-last, with the reference's heads
    (``soccerdiffusion_tpu/models/vision.py:ResNetImageEncoder``): 7x7/2 conv
    + BN + ReLU, 3x3/2 max pool (padded with -inf), four stages of blocks at
    64, 128, 256, 512 filters (x4 for the bottleneck), then with
    ``use_final_avgpool`` the spatial mean, else a 1x1 conv to 32 channels
    over the final map flattened in (h, w, c) order, and Dense(hidden).
    (N, H, W, 3) normalised frames, cast to ``dtype``, -> (N, hidden)."""

    def __init__(self, hidden_dim: int, image_resolution: int, stage_sizes=(2, 2, 2, 2),
                 bottleneck: bool = False, use_final_avgpool: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool | str = False):
        super().__init__()
        self.dtype, self.use_final_avgpool, self.remat = dtype, use_final_avgpool, remat
        self.conv1 = Conv2d(3, 64, 7, 2, ((3, 3), (3, 3)), bias=False)
        self.bn1 = BatchNorm(64)
        block, cin, self.block_names = BottleneckBlock if bottleneck else BasicBlock, 64, []
        for stage, num_blocks in enumerate(stage_sizes):
            for i in range(num_blocks):
                blk = block(cin, 64 * 2 ** stage, 2 if stage > 0 and i == 0 else 1)
                self.add_module(f"layer{stage + 1}_{i}", blk)
                self.block_names.append(f"layer{stage + 1}_{i}")
                cin = blk.out_channels
        if use_final_avgpool:
            head_in = cin
        else:
            self.spatial_head_conv = Conv2d(cin, 32, 1)
            head_in = 32 * resnet_map_size(image_resolution) ** 2
        self.fc = Linear(head_in, hidden_dim)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_final_avgpool:
            x = x.mean(dim=(1, 2))
        else:
            x = self.spatial_head_conv(x).reshape(x.shape[0], -1)  # (h, w, c) order
        return self.fc(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        context = conv_only_context if self.remat == "conv_only" else None
        for stage in [self.stem] + [getattr(self, name) for name in self.block_names]:
            x = remat(stage, x, context_fn=context) if self.remat else stage(x)
        return self.head(x)


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
                 attention_impl: str = "xla", remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        num_patches = (image_resolution // patch_size) ** 2
        self.patch_kernel = nn.Parameter(torch.zeros(patch_size * patch_size * 3, width))  # RGB
        self.patch_bias = nn.Parameter(torch.zeros(width))
        self.pos = PositionalEncoding(width, num_patches)
        self.blocks = TransformerEncoder(width, self.num_heads, depth, ff_dim=4 * width,
                                         fused_block=fused_block, fused_gelu=fused_gelu,
                                         attention_impl=attention_impl, remat=remat)
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
                       use_final_avgpool: bool = True, vit_geometry: tuple = (16, 192, 6),
                       vit_fused_block: bool = False, vit_fused_gelu: str = "exact",
                       dtype: torch.dtype = torch.float32, attention_impl: str = "xla",
                       remat: bool | str = False) -> nn.Module:
    """The per-frame encoder of ``encoder_type`` (the JAX factory's names:
    "resnet18", "resnet50", "vit", "swin_transformer_tiny",
    "swin_transformer_small"); ``remat`` is ``remat_image_encoder``."""
    if encoder_type not in VALID_IMAGE_ENCODERS:
        raise ValueError(f"unknown image encoder type: {encoder_type}")
    check_remat_image_encoder(remat, encoder_type)
    if encoder_type in ("resnet18", "resnet50"):
        stages, bottleneck = ((2, 2, 2, 2), False) if encoder_type == "resnet18" else \
            ((3, 4, 6, 3), True)
        return ResNetImageEncoder(hidden_dim, image_resolution, stages, bottleneck,
                                  use_final_avgpool, dtype, remat)
    if encoder_type == "vit":
        patch, width, depth = vit_geometry
        return ViTImageEncoder(hidden_dim, image_resolution, patch_size=patch, width=width,
                               depth=depth, fused_block=vit_fused_block,
                               fused_gelu=vit_fused_gelu, dtype=dtype,
                               attention_impl=attention_impl, remat=bool(remat))
    return SwinImageEncoder(hidden_dim, "tiny" if encoder_type.endswith("tiny") else "small",
                            image_resolution, dtype=dtype, remat=bool(remat))


class ImageSequenceEncoder(nn.Module):
    """(B, T, H, W, 3) frames, or pre-patchified (B, T, patches, P*P*3), ->
    (B, T, hidden) context tokens: each frame through the per-frame encoder,
    then (``sequence_encoder_type="transformer"``) a patch-1, 8-head encoder
    stack across the T frame tokens. With ``valid`` (B, T) the frames are
    raw uint8: the ViT folds their normalisation, the other encoders take
    them through ``device_normalize_images``. Pre-patchified frames are the
    ViT's layout only.

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
                 dtype: torch.dtype = torch.float32, attention_impl: str = "xla",
                 use_final_avgpool: bool = True, remat: bool | str = False):
        super().__init__()
        self.hidden_dim, self.encoder_type = hidden_dim, encoder_type
        self.image_encoder = make_image_encoder(encoder_type, hidden_dim, image_resolution,
                                                use_final_avgpool, vit_geometry, vit_fused_block,
                                                vit_fused_gelu, dtype, attention_impl, remat)
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
            vit = self.encoder_type == "vit"
            if x.ndim == 4 and not vit:
                raise ValueError("pre-patchified frames (B, T, patches, P*P*C) are a ViT-only "
                                 "input layout (data/pipeline.patchify_frames)")
            if valid is not None and not vit:
                x, valid = device_normalize_images(x, valid), None
            frames = x.reshape(b * t, *x.shape[2:])
            tokens = (self.image_encoder(frames) if valid is None
                      else self.image_encoder(frames, valid.reshape(b * t)))
            tokens = tokens.reshape(b, t, self.hidden_dim)
            if mode == "frames":
                return tokens
        return tokens if self.seq is None else self.seq(tokens)
