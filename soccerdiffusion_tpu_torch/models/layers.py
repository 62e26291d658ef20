"""Leaf modules whose float32 parameters are cast to the input's dtype at
use, as flax's ``dtype=`` casts its float32 params per call.

The policy keeps float32 master parameters (the optimizer updates them in
float32) and casts its inputs to ``cfg.compute_dtype`` at its boundaries
(``DiffusionPolicy.encode_context`` / ``denoise``), so every activation
reaching these modules is already in the compute dtype. The bf16 values
that reach each op are the ones a bf16 copy of the weights would hold."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.ops._train_math import LN_EPS  # noqa: F401 (flax's default)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
