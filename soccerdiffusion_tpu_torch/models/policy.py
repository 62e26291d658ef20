"""The multimodal diffusion policy (counterpart of
``soccerdiffusion_tpu/models/policy.py``): proprioceptive encoder stacks,
the ViT image pathway, the game-state token and the cross-attending
denoiser.

Parameters are float32 masters, as in the JAX package, and are cast to
``cfg.compute_dtype`` at use (``models/layers.py``); the inputs (frames and
cached image tokens included) are cast to it here, at the policy's
boundaries. The knobs ``encoder_fused_stack`` and ``decoder_fused_block``
route the encoder stacks (the image-frame sequence encoder's among them)
and the decoder layers through the fused fwd+bwd ops
(``ops/fused_encoder_stack.py``, ``ops/fused_decoder_layer.py``);
``vit_fused_block`` runs each ViT block as one fused op
(``ops/fused_vit_block.py``). ``attention_impl`` picks the attention
backend of every unfused layer (``models/attention.py``): with all three
knobs off and "pallas", every attention of the model runs the flash
kernel (``ops/flash_attention.py``)."""

from __future__ import annotations

import torch
from torch import nn

from soccerdiffusion_tpu_torch.config import ModelConfig, check_supported
from soccerdiffusion_tpu_torch.models.decoder import DiffusionActionGenerator
from soccerdiffusion_tpu_torch.models.embeddings import StepToken
from soccerdiffusion_tpu_torch.models.encoders import GameStateEncoder, IMUEncoder, JointEncoder
from soccerdiffusion_tpu_torch.models.vision import ImageSequenceEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiffusionPolicy(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        E, ps = cfg.hidden_dim, cfg.encoder_patch_size
        fused, attn = cfg.encoder_fused_stack, cfg.attention_impl
        self.step_encoding = StepToken(E)
        if cfg.use_action_history:
            self.action_history_encoder = JointEncoder(
                cfg.num_joints, E, ps, cfg.num_action_history_encoder_layers,
                cfg.action_context_length, fused, attn)
        if cfg.use_imu:
            self.imu_encoder = IMUEncoder(cfg.imu_input_dim, E, ps, cfg.num_imu_encoder_layers,
                                          cfg.imu_context_length, fused, attn)
        if cfg.use_joint_states:
            self.joint_states_encoder = JointEncoder(
                cfg.num_joints, E, ps, cfg.joint_state_encoder_layers,
                cfg.joint_state_context_length, fused, attn)
        if cfg.use_images:
            self.image_sequence_encoder = ImageSequenceEncoder(
                E, cfg.image_encoder_type, cfg.image_sequence_encoder_type,
                cfg.num_image_sequence_encoder_layers, cfg.image_context_length,
                cfg.image_resolution, (cfg.vit_patch_size, cfg.vit_width, cfg.vit_depth),
                cfg.vit_fused_block, cfg.vit_fused_gelu, fused, _DTYPES[cfg.compute_dtype], attn)
        if cfg.use_gamestate:
            self.game_state_encoder = GameStateEncoder(E)
        self.diffusion_action_generator = DiffusionActionGenerator(
            cfg.num_joints, E, cfg.num_decoder_layers, cfg.trajectory_prediction_length,
            num_heads=cfg.num_decoder_heads, fused_block=cfg.decoder_fused_block,
            attention_impl=attn)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.config.compute_dtype]

    def encode_context(self, batch: dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
        """(B, S, hidden) context tokens in canonical order: action history,
        IMU, joint states, images, game state. The image tokens come from
        ``batch["image_tokens"]`` (the serving cache of per-frame encodings,
        (B, F, hidden): only the frame-sequence encoder runs), from the packed
        raw uint8 frames ``batch["image_u8"]`` (B, F, H, W, 3) or
        pre-patchified (B, F, patches, P*P*3) with ``batch["image_valid"]``
        (B, F) (the ViT folds their normalisation), or from the normalised
        frames ``batch["image_data"]``."""
        cfg = self.config
        context = []
        if cfg.use_action_history:
            context.append(self.action_history_encoder(batch["joint_command_history"].to(self.dtype)))
        if cfg.use_imu:
            context.append(self.imu_encoder(batch["rotation"].to(self.dtype)))
        if cfg.use_joint_states:
            context.append(self.joint_states_encoder(batch["joint_state"].to(self.dtype)))
        if cfg.use_images:
            if "image_tokens" in batch:
                context.append(self.image_sequence_encoder(batch["image_tokens"].to(self.dtype),
                                                           mode="sequence"))
            elif "image_u8" in batch:
                context.append(self.image_sequence_encoder(batch["image_u8"],
                                                           valid=batch["image_valid"]))
            else:
                context.append(self.image_sequence_encoder(batch["image_data"].to(self.dtype)))
        if cfg.use_gamestate:
            context.append(self.game_state_encoder(batch["game_state"]).to(self.dtype))
        if not context:
            raise ValueError("no context modality enabled")
        return torch.cat(context, dim=1)

    def encode_image_frames(self, frames: torch.Tensor,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
        """Per-frame image tokens (B, K, hidden) of frames (B, K, H, W, 3),
        without the frame-sequence encoder: the cacheable half of the image
        pathway, run once per frame as it arrives."""
        frames = frames if valid is not None else frames.to(self.dtype)  # raw uint8 with valid
        return self.image_sequence_encoder(frames, valid=valid, mode="frames")

    def forward_with_cue(self, *args, **kwargs):
        raise NotImplementedError("aux_cue_head / forward_with_cue (a training head) is not "
                                  "ported yet (see ROADMAP.md, 'H100 port')")

    def denoise(self, context: torch.Tensor, noisy_chunk: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Epsilon for the noisy chunk given context tokens; t is (B,) ints."""
        full_context = torch.cat([context.to(self.dtype), self.step_encoding(t).to(self.dtype)], dim=1)
        return self.diffusion_action_generator(noisy_chunk.to(self.dtype), full_context).float()

    def precompute_context_kv(self, context: torch.Tensor) -> list:
        """Per-layer cross-attention K/V of the static context tokens,
        projected once per chunk and reused by every denoising step."""
        return self.diffusion_action_generator.compute_context_kv(context)

    def denoise_with_kv(self, context_kv: list, noisy_chunk: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """``denoise`` against cached context K/V; only the step token is
        projected fresh."""
        out = self.diffusion_action_generator(noisy_chunk.to(self.dtype),
                                              self.step_encoding(t).to(self.dtype), context_kv)
        return out.float()

    def forward(self, batch: dict[str, torch.Tensor], noisy_chunk: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        return self.denoise(self.encode_context(batch), noisy_chunk, t)
