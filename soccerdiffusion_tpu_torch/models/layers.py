"""Leaf modules whose float32 parameters are cast to the input's dtype at
use, as flax's ``dtype=`` casts its float32 params per call.

The policy keeps float32 master parameters (the optimizer updates them in
float32) and casts its inputs to ``cfg.compute_dtype`` at its boundaries
(``DiffusionPolicy.encode_context`` / ``denoise``), so every activation
reaching these modules is already in the compute dtype. The bf16 values
that reach each op are the ones a bf16 copy of the weights would hold."""

from __future__ import annotations

import threading

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from soccerdiffusion_tpu_torch.ops._train_math import LN_EPS  # noqa: F401 (flax's default)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """A 2-D convolution over channels-last (N, H, W, C) input, returning
    (N, H, W, C'), with flax ``nn.Conv``'s padding: "SAME" (the output
    ceil(in / stride), any odd total padding on the high side), "VALID" or
    explicit ((lo, hi), (lo, hi)) pairs. The weight is the float32 master
    (out, in, kh, kw), cast to the input's dtype at use. The NHWC tensor is
    handed to ``F.conv2d`` as its NCHW view in ``torch.channels_last`` memory
    (no copy), so cuDNN runs its channels-last kernels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding="SAME", bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=0,
                         bias=bias)
        self.flax_padding = padding

    def pads(self, h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
        """((top, bottom), (left, right)) zero padding for an h x w input."""
        if self.flax_padding == "VALID":
            return (0, 0), (0, 0)
        if self.flax_padding == "SAME":
            out = []
            for n, k, s in zip((h, w), self.kernel_size, self.stride):
                total = max((-(-n // s) - 1) * s + k - n, 0)
                out.append((total // 2, total - total // 2))
            return tuple(out)
        return tuple(tuple(p) for p in self.flax_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = self.pads(x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        if t == b and l == r:
            pad = (t, l)
        else:
            x, pad = F.pad(x, (l, r, t, b)), (0, 0)
        weight = self.weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.contiguous(memory_format=torch.channels_last), weight, bias, self.stride,
                     pad)
        return y.permute(0, 2, 3, 1)


class _Recompute(threading.local):
    active = False


_RECOMPUTE = _Recompute()


def remat(fn, *args, context_fn=None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (``use_reentrant=False``;
    ``context_fn`` for a selective policy), where grad is enabled; a plain
    call otherwise. While the backward recomputes ``fn``, ``BatchNorm``
    leaves its running statistics alone, so that a step updates them once,
    as flax's ``nn.remat`` does."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = 0

    def body(*a):
        nonlocal calls
        calls += 1
        before, _RECOMPUTE.active = _RECOMPUTE.active, calls > 1
        try:
            return fn(*a)
        finally:
            _RECOMPUTE.active = before

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(body, *args, use_reentrant=False, **kw)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (channel) axis, momentum 0.9, eps
    1e-5: params ``weight`` / ``bias`` (flax ``scale`` / ``bias``) and the
    float32 running ``mean`` / ``var`` buffers (flax ``batch_stats``).

    ``self.training``: normalise with the batch's statistics, reduced in
    float32 whatever the input's dtype (flax's ``force_float32_reductions``)
    with the *biased* variance, and update ``ra = 0.9 ra + 0.1 batch`` for
    both; ``torch.nn.BatchNorm2d`` would update the variance with the
    unbiased n / (n - 1) estimate. flax reduces the variance as E[x^2] -
    E[x]^2; the two-pass ``var_mean`` here is the same quantity, nearer the
    exact one in float32 (ROADMAP Queue 3). Eval:
    normalise with the running statistics. The result is (x - mean) *
    rsqrt(var + eps) * weight + bias in float32, cast to the input's dtype.
    The batch statistics come from one ``aten.var_mean`` call, which the
    "conv_only" remat policy saves (``models/vision.py``)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # at least float32
        if self.training:
            var, mean = torch.var_mean(x32, dim=tuple(range(x.ndim - 1)), correction=0)
            if not _RECOMPUTE.active:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                    self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(x.dtype)
