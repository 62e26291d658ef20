"""Per-joint normalization statistics (counterpart of
``soccerdiffusion_tpu/data/normalizer.py``).

``fit`` uses the unbiased (ddof=1) standard deviation, as ``torch.Tensor.std``
does by default, so stats fitted here and stats in ported checkpoints agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Normalizer:
    mean: torch.Tensor  # (J,)
    std: torch.Tensor  # (J,)

    @classmethod
    def fit(cls, data) -> "Normalizer":
        """data: (N, J) samples."""
        arr = np.asarray(data, dtype=np.float32)
        std = arr.std(axis=0, ddof=1)
        if np.any(std == 0):
            raise ValueError("normalization std is zero: some joints are constant")
        return cls(mean=torch.from_numpy(arr.mean(axis=0)), std=torch.from_numpy(std))

    @classmethod
    def identity(cls, num_joints: int) -> "Normalizer":
        return cls(mean=torch.zeros(num_joints), std=torch.ones(num_joints))

    def to(self, device) -> "Normalizer":
        return Normalizer(mean=self.mean.to(device), std=self.std.to(device))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.std + self.mean
