"""Configuration: the JAX package's ``Config``, ``ModelConfig`` and
``TrainConfig``, re-exported.

``soccerdiffusion_tpu.config`` imports only ``dataclasses`` and ``typing``
(yaml lazily), so it loads without jax. ``check_supported`` rejects the
settings this port does not carry yet; ROADMAP.md lists when each comes.
"""

from __future__ import annotations

from soccerdiffusion_tpu.config import Config, ModelConfig, TrainConfig

__all__ = ["Config", "ModelConfig", "TrainConfig", "check_supported"]

_SEE = "not ported yet (see ROADMAP.md, 'H100 port')"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a setting outside the ported slice.

    ``attention_impl="auto"`` is accepted: the JAX package resolves it to
    the plain (xla) attention everywhere but on a TPU
    (``ops/flash_attention.py:flash_attention_auto``).

    ``encoder_fused_stack`` and ``decoder_fused_block`` are accepted (the
    fused fwd+bwd ops of ``ops/fused_encoder_stack.py`` and
    ``ops/fused_decoder_layer.py``). ``encoder_fused_block_rows`` and
    ``decoder_fused_block_rows`` are the TPU kernels' robot blocks; they are
    accepted and have no effect, since a CUDA grid masks its own ragged
    edge. ``encoder_fused_block`` (the per-layer fused ViT block) is not
    ported."""
    if cfg.use_images:
        raise NotImplementedError(f"use_images: the image path is {_SEE}")
    if cfg.attention_impl not in ("xla", "auto"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r}: flash/ring attention is {_SEE}")
    if cfg.encoder_fused_block:
        raise NotImplementedError(f"encoder_fused_block: the fused ViT block is {_SEE}")


def check_serving_supported(group_robots: int = 1, kv_quant: str = "none",
                            cross_orientation: str = "kstat",
                            guidance_scale: float = 1.0) -> None:
    """Raise ``NotImplementedError`` for a serving option outside the slice."""
    if guidance_scale != 1.0:
        raise NotImplementedError(f"classifier-free guidance is {_SEE}")
    if kv_quant != "none":
        raise NotImplementedError(f"context_kv_quant={kv_quant!r} is {_SEE}")
    if group_robots != 1:
        raise NotImplementedError(f"group_robots={group_robots} is {_SEE}")
    if cross_orientation != "kstat":
        raise NotImplementedError(f"cross_orientation={cross_orientation!r} is {_SEE}")
