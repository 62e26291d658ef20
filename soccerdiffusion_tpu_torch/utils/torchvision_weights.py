"""ImageNet-pretrained torchvision ResNet weights into the port's ResNet
image encoder (counterpart of ``load_imagenet_backbone`` /
``apply_pretrained_backbone`` in ``soccerdiffusion_tpu/utils/torch_port.py``).

The weights come from a local ``.pth`` file holding a torchvision
``resnet18`` / ``resnet50`` state dict; nothing is fetched. torchvision's
names map onto the port's flax-named modules:

  conv1, bn1                      -> conv1, bn1
  layer{s}.{i}.conv{k}, .bn{k}    -> layer{s}_{i}.conv{k}, .bn{k}
  layer{s}.{i}.downsample.0 / .1  -> layer{s}_{i}.downsample_conv / downsample_bn
  bn running_mean / running_var   -> the BatchNorm's mean / var buffers

Conv weights keep their (out, in, kh, kw) layout. torchvision's ``fc`` head
and its ``num_batches_tracked`` counters are not used: the reference
replaces the head, so ``fc`` and ``spatial_head_conv`` keep their init.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch
from torch import nn

from soccerdiffusion_tpu_torch.models.vision import ResNetImageEncoder

_BN = {"weight": "weight", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def port_name(name: str) -> str | None:
    """The port's state-dict key of a torchvision ResNet key, or None for a
    key the backbone does not take (the fc head, num_batches_tracked)."""
    if name.startswith("fc.") or name.endswith("num_batches_tracked"):
        return None
    module, leaf = name.rsplit(".", 1)
    module = re.sub(r"^layer(\d+)\.(\d+)\.", r"layer\1_\2.", module)
    module = module.replace("downsample.0", "downsample_conv").replace("downsample.1",
                                                                       "downsample_bn")
    is_bn = re.search(r"(^|\.)(bn\d|downsample_bn)$", module) is not None
    return f"{module}.{_BN[leaf] if is_bn else leaf}"


def resnet_encoder(model: nn.Module) -> ResNetImageEncoder:
    """The ResNet frame encoder of a ``DiffusionPolicy`` (or the encoder itself)."""
    enc = model
    if not isinstance(enc, ResNetImageEncoder):
        enc = getattr(getattr(model, "image_sequence_encoder", None), "image_encoder", None)
    if not isinstance(enc, ResNetImageEncoder):
        raise ValueError("pretrained ImageNet weights initialise the ResNet18 / ResNet50 image "
                         f"encoders only; {type(model).__name__} has none")
    return enc


@torch.no_grad()
def load_imagenet_backbone(model: nn.Module, path: str | Path) -> nn.Module:
    """Fill the ResNet backbone of ``model`` (a ``DiffusionPolicy`` or a
    ``ResNetImageEncoder``) in place from the torchvision state dict at
    ``path`` (``torch.load(weights_only=True)``), onto the model's device;
    every backbone tensor is filled and every torchvision key but the fc
    head and the batch counters is used, shapes checked. Returns ``model``."""
    if str(path) == "auto":
        raise ValueError("pretrained_weights='auto' would download torchvision's ImageNet "
                         "weights; the port reads a local file only: pass the path of a "
                         "torchvision resnet18 / resnet50 state dict (.pth)")
    enc = resnet_encoder(model)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    targets = {k: v for k, v in enc.state_dict(keep_vars=True).items()
               if not k.startswith(("fc.", "spatial_head_conv."))}
    filled = set()
    for name, value in sd.items():
        key = port_name(name)
        if key is None:
            continue
        if key not in targets:
            raise KeyError(f"{path}: {name} maps to {key}, which the "
                           f"{type(enc).__name__} does not hold (a resnet18 / resnet50 "
                           "state dict of the encoder's depth?)")
        if tuple(value.shape) != tuple(targets[key].shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} does not map onto {key} of "
                             f"shape {tuple(targets[key].shape)}")
        targets[key].copy_(value.float())
        filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{path} holds no weights for {missing}")
    return model
