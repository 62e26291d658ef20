"""Swin Transformer image encoder, tiny and small (counterpart of
``soccerdiffusion_tpu/models/swin.py``): a 4x4 patch embedding, windowed
multi-head self-attention with a relative position bias, shifted windows
on every second block, patch merging between stages, MLP ratio 4, laid out
channels-last (N, H, W, C).

Variants: tiny = depths (2, 2, 6, 2), small = (2, 2, 18, 2); both embed 96
with heads (3, 6, 12, 24) and window 7. A stage whose map is smaller than
the window attends over the whole map in one window and does not shift (at
224 px: the last stage, 7x7). Attention scores stay float32; the
probabilities are cast to the compute dtype before the value product.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.models.layers import LN_EPS, Conv2d, LayerNorm, Linear, remat

SWIN_DEPTHS = {"tiny": (2, 2, 6, 2), "small": (2, 2, 18, 2)}


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, window * window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def window_unpartition(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_position_index(window: int) -> np.ndarray:
    """(window^2, window^2) index table into the (2 window - 1)^2 bias rows."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """The additive (-100 / 0) mask (nW, N, N) of shifted-window attention:
    keys from another region of the rolled map are masked."""
    img = np.zeros((h, w), dtype=np.float32)
    regions = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for cnt, (hs, ws) in enumerate((hs, ws) for hs in regions for ws in regions):
        img[hs, ws] = cnt
    win = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head self-attention within each window, with the learned
    relative position bias (``relative_position_bias_table``, (2w-1)^2 x
    heads) and an optional additive window mask."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("index", torch.from_numpy(relative_position_index(window).ravel()),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (nW B, N, C); mask (nW, N, N) or None."""
        nwb, n, c = x.shape
        h, d = self.num_heads, c // self.num_heads
        q, k, v = self.qkv(x).reshape(nwb, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        # float32 scores of the compute-dtype q, k (the JAX einsum's preferred_element_type)
        attn = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        bias = self.relative_position_bias_table[self.index].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(nwb // nw, nw, h, n, n) + mask[None, :, None]).reshape(nwb, h, n, n)
        p = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(nwb, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> + skip; LN -> MLP (exact GELU) -> + skip.
    On a ``map_size`` map smaller than the window the window shrinks to the
    map (its bias table with it), and a window that covers the map does not
    shift."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 map_size: int | None = None):
        super().__init__()
        if map_size is not None:
            window = min(window, map_size)
            shift = shift if window < map_size else 0
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = Linear(dim, 4 * dim)
        self.mlp_fc2 = Linear(4 * dim, dim)
        self._masks: dict = {}

    def mask(self, h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
        key = (h, w, window, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(h, w, window, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        window = self.window
        if min(h, w) < window:
            raise ValueError(f"a {h}x{w} map is smaller than this block's {window}-window "
                             "(build the encoder for the frames' resolution)")
        shift = self.shift if window < min(h, w) else 0
        y = self.norm1(x)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self.mask(h, w, window, shift, x.device)
        y = window_unpartition(self.attn(window_partition(y, window), mask), window, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, H/2, W/2, 2C): each 2x2 patch's four C-vectors
    concatenated in row-major order, LayerNorm, a bias-free Dense to 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinImageEncoder(nn.Module):
    """(N, H, W, 3) normalised frames, cast to ``dtype``, -> (N, hidden):
    patch embed (4x4/4 conv) + LN, the four stages (window 7, the shift 3
    on odd blocks) with patch merging between them, LN, spatial mean,
    Dense(hidden) (``head``). A stage's window is min(7, its map side), as
    in the JAX encoder, so the bias tables follow ``image_resolution`` (at
    224 px every stage keeps 7: maps of 56, 28, 14, 7). ``remat``
    recomputes the blocks in the backward, each block (and merge) a
    checkpoint region of its own (``models/vision.py`` says why)."""

    def __init__(self, hidden_dim: int, variant: str = "tiny", image_resolution: int = 224,
                 embed_dim: int = 96, window: int = 7, num_heads=(3, 6, 12, 24),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if variant not in SWIN_DEPTHS:
            raise ValueError(f"unknown Swin variant {variant!r}")
        self.dtype, self.remat, self.block_names = dtype, remat, []
        self.patch_embed = Conv2d(3, embed_dim, 4, 4, "VALID")
        self.patch_norm = LayerNorm(embed_dim, eps=LN_EPS)
        depths, dim = SWIN_DEPTHS[variant], embed_dim
        for stage, depth in enumerate(depths):
            side = image_resolution // 4 // 2 ** stage
            for i in range(depth):
                name = f"stage{stage}_block{i}"
                self.add_module(name, SwinBlock(dim, num_heads[stage], window,
                                                0 if i % 2 == 0 else window // 2, side))
                self.block_names.append(name)
            if stage < len(depths) - 1:
                self.add_module(f"merge{stage}", PatchMerging(dim))
                self.block_names.append(f"merge{stage}")
                dim *= 2
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.head = Linear(dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm(self.patch_embed(x.to(self.dtype)))
        for name in self.block_names:
            block = getattr(self, name)
            x = remat(block, x) if self.remat else block(x)
        return self.head(self.norm(x).mean(dim=(1, 2)))
