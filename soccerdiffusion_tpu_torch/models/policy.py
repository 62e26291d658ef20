"""The multimodal diffusion policy (counterpart of
``soccerdiffusion_tpu/models/policy.py``): proprioceptive encoder stacks,
the image pathway (ResNet, Swin or ViT frames, then the frame-sequence
encoder), the game-state token and the cross-attending denoiser; with
every context modality off (the decoder-only tier) the denoiser conditions
on the diffusion step token alone.

BatchNorm (the ResNets) follows the module's mode, as flax's ``train``
argument does: ``model.train()`` normalises with the batch statistics and
updates the running ones, ``model.eval()`` uses the running ones (what the
JAX package's serving applies with ``train=False``).

Parameters are float32 masters, as in the JAX package, and are cast to
``cfg.compute_dtype`` at use (``models/layers.py``); the inputs (frames and
cached image tokens included) are cast to it here, at the policy's
boundaries. The knobs ``encoder_fused_stack`` and ``decoder_fused_block``
route the encoder stacks (the image-frame sequence encoder's among them)
and the decoder layers through the fused fwd+bwd ops
(``ops/fused_encoder_stack.py``, ``ops/fused_decoder_layer.py``);
``vit_fused_block`` runs each ViT block as one fused op
(``ops/fused_vit_block.py``), ``encoder_fused_block`` each layer of the
three proprioceptive stacks as one such op (exact GELU; the fused stack
wins where both are set). ``attention_impl`` picks the attention
backend of every unfused layer (``models/attention.py``): with all three
knobs off and "pallas", every attention of the model runs the flash
kernel (``ops/flash_attention.py``).

With ``aux_cue_head`` (image configs) the policy has ``cue_head``, a
Linear(hidden, 1) that ``forward_with_cue`` applies, in float32, to the
newest frame's per-frame image token: the auxiliary cue regression that the
train step weights in with ``aux_cue_weight``."""

from __future__ import annotations

import torch
from torch import nn

from soccerdiffusion_tpu_torch.config import ModelConfig, check_supported
from soccerdiffusion_tpu_torch.models.decoder import DiffusionActionGenerator
from soccerdiffusion_tpu_torch.models.embeddings import StepToken
from soccerdiffusion_tpu_torch.models.encoders import GameStateEncoder, IMUEncoder, JointEncoder
from soccerdiffusion_tpu_torch.models.layers import Linear
from soccerdiffusion_tpu_torch.models.vision import ImageSequenceEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiffusionPolicy(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        E, ps = cfg.hidden_dim, cfg.encoder_patch_size
        fused, attn = cfg.encoder_fused_stack, cfg.attention_impl
        # the proprioceptive stacks: one fused op a stack, or one fused ViT
        # block a layer (encoder_fused_block; the image sequence stack takes
        # only encoder_fused_stack, as in the JAX package)
        prop = dict(fused_stack=fused, attention_impl=attn, fused_block=cfg.encoder_fused_block)
        self.step_encoding = StepToken(E)
        if cfg.use_action_history:
            self.action_history_encoder = JointEncoder(
                cfg.num_joints, E, ps, cfg.num_action_history_encoder_layers,
                cfg.action_context_length, **prop)
        if cfg.use_imu:
            self.imu_encoder = IMUEncoder(cfg.imu_input_dim, E, ps, cfg.num_imu_encoder_layers,
                                          cfg.imu_context_length, **prop)
        if cfg.use_joint_states:
            self.joint_states_encoder = JointEncoder(
                cfg.num_joints, E, ps, cfg.joint_state_encoder_layers,
                cfg.joint_state_context_length, **prop)
        if cfg.use_images:
            self.image_sequence_encoder = ImageSequenceEncoder(
                E, cfg.image_encoder_type, cfg.image_sequence_encoder_type,
                cfg.num_image_sequence_encoder_layers, cfg.image_context_length,
                cfg.image_resolution, (cfg.vit_patch_size, cfg.vit_width, cfg.vit_depth),
                cfg.vit_fused_block, cfg.vit_fused_gelu, fused, _DTYPES[cfg.compute_dtype], attn,
                cfg.image_use_final_avgpool, cfg.remat_image_encoder)
        if cfg.use_gamestate:
            self.game_state_encoder = GameStateEncoder(E)
        if cfg.use_images and cfg.aux_cue_head:
            self.cue_head = Linear(E, 1)
        self.diffusion_action_generator = DiffusionActionGenerator(
            cfg.num_joints, E, cfg.num_decoder_layers, cfg.trajectory_prediction_length,
            num_heads=cfg.num_decoder_heads, fused_block=cfg.decoder_fused_block,
            attention_impl=attn, remat=cfg.remat_decoder)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.config.compute_dtype]

    def encode_context(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, S, hidden) context tokens in canonical order: action history,
        IMU, joint states, images, game state. The image tokens come from
        ``batch["image_tokens"]`` (the serving cache of per-frame encodings,
        (B, F, hidden): only the frame-sequence encoder runs), from the packed
        raw uint8 frames ``batch["image_u8"]`` (B, F, H, W, 3) or
        pre-patchified (B, F, patches, P*P*3) with ``batch["image_valid"]``
        (B, F) (the ViT folds their normalisation), or from the normalised
        frames ``batch["image_data"]``. The decoder-only tier returns (B, 0,
        hidden), B from the batch's ``joint_command`` (the serving batch
        carries a zero-width one, ``inference/controller.py``)."""
        return self._context(batch)[0]

    def _context(self, batch: dict[str, torch.Tensor], want_frame_tokens: bool = False):
        """(context, per-frame image tokens): with ``want_frame_tokens`` the
        image pathway runs as its two halves (frames, then the sequence
        encoder; the same function) and its (B, F, hidden) frame tokens come
        back, else None."""
        cfg = self.config
        frame_tokens = None
        context = []
        if cfg.use_action_history:
            context.append(self.action_history_encoder(batch["joint_command_history"].to(self.dtype)))
        if cfg.use_imu:
            context.append(self.imu_encoder(batch["rotation"].to(self.dtype)))
        if cfg.use_joint_states:
            context.append(self.joint_states_encoder(batch["joint_state"].to(self.dtype)))
        if cfg.use_images:
            if "image_tokens" in batch:
                frame_tokens = batch["image_tokens"].to(self.dtype)
                context.append(self.image_sequence_encoder(frame_tokens, mode="sequence"))
            elif want_frame_tokens:
                frame_tokens = (self.encode_image_frames(batch["image_u8"], batch["image_valid"])
                                if "image_u8" in batch
                                else self.encode_image_frames(batch["image_data"]))
                context.append(self.image_sequence_encoder(frame_tokens, mode="sequence"))
            elif "image_u8" in batch:
                context.append(self.image_sequence_encoder(batch["image_u8"],
                                                           valid=batch["image_valid"]))
            else:
                context.append(self.image_sequence_encoder(batch["image_data"].to(self.dtype)))
        if cfg.use_gamestate:
            context.append(self.game_state_encoder(batch["game_state"]).to(self.dtype))
        if not context:
            bsz = batch["joint_command"].shape[0]
            return torch.zeros((bsz, 0, cfg.hidden_dim), dtype=self.dtype,
                               device=self.step_encoding.token.device), None
        return torch.cat(context, dim=1), frame_tokens

    def encode_image_frames(self, frames: torch.Tensor,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
        """Per-frame image tokens (B, K, hidden) of frames (B, K, H, W, 3),
        without the frame-sequence encoder: the cacheable half of the image
        pathway, run once per frame as it arrives."""
        frames = frames if valid is not None else frames.to(self.dtype)  # raw uint8 with valid
        return self.image_sequence_encoder(frames, valid=valid, mode="frames")

    def forward_with_cue(self, batch: dict[str, torch.Tensor], noisy_chunk: torch.Tensor,
                         t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(eps, cue)``: the forward, and ``cue_head`` (B,) on the newest
        frame's per-frame token in float32, from the same image encode as the
        main pathway. Needs ``aux_cue_head`` (a training head)."""
        if not hasattr(self, "cue_head"):
            raise ValueError("forward_with_cue needs an image config with aux_cue_head")
        context, frame_tokens = self._context(batch, want_frame_tokens=True)
        cue = self.cue_head(frame_tokens[:, -1].float())[..., 0]
        return self.denoise(context, noisy_chunk, t), cue

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
