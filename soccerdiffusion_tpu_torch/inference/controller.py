"""Closed-loop controller state (counterpart of
``soccerdiffusion_tpu/inference/controller.py``).

Rolling per-robot buffers with a leading batch dimension. Conventions of the
reference ROS node: joint buffers hold [-pi, pi] values and are shifted to
[0, 2 pi) only when the model batch is built (``(x + 3 pi) % 2 pi``); the
predicted chunk (already in [0, 2 pi)) enters the action history with a -pi
shift; buffers start at zeros. Updates return a new state.

Image configs hold either the raw frames (``images``, (B, F, H, W, 3)
NHWC) or the serving-side token cache (``image_tokens``, (B, F, hidden)):
the per-frame encodings, rolled as each frame arrives, so that a replan
runs only the frame-sequence encoder.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from soccerdiffusion_tpu_torch.config import ModelConfig

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class ControllerState:
    joint_command_history: torch.Tensor  # (B, A, J) in [-pi, pi]
    joint_state_history: torch.Tensor  # (B, S, J) in [-pi, pi]
    imu_history: torch.Tensor  # (B, I, 4|5)
    game_state: torch.Tensor  # (B,) int64
    images: torch.Tensor | None = None  # (B, F, H, W, 3) preprocessed, or None
    image_tokens: torch.Tensor | None = None  # (B, F, hidden) cached encodings, or None

    def replace(self, **updates) -> "ControllerState":
        return dataclasses.replace(self, **updates)


def init_controller_state(config: ModelConfig, batch_size: int = 1,
                          device: str | torch.device = "cuda",
                          cache_image_tokens: bool = False) -> ControllerState:
    """Zero buffers on ``device`` (the card unless the caller asks for the
    CPU). ``cache_image_tokens`` holds the image context as per-frame tokens
    instead of raw frames; their zeros are a placeholder that
    ``RolloutEngine.init`` fills with the zero-frame encoding."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
    cfg, b = config, batch_size
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    images = image_tokens = None
    if cfg.use_images and cache_image_tokens:
        image_tokens = zeros(b, cfg.image_context_length, cfg.hidden_dim)
    elif cfg.use_images:
        res = cfg.image_resolution
        images = zeros(b, cfg.image_context_length, res, res, 3)
    return ControllerState(
        joint_command_history=zeros(b, cfg.action_context_length, cfg.num_joints),
        joint_state_history=zeros(b, cfg.joint_state_context_length, cfg.num_joints),
        imu_history=zeros(b, cfg.imu_context_length, cfg.imu_input_dim),
        # the reference node pins game_state to 2 (STOPPED) during play
        game_state=torch.full((b,), 2, dtype=torch.int64, device=device),
        images=images,
        image_tokens=image_tokens,
    )


def _roll_append(buffer: torch.Tensor, new_rows: torch.Tensor) -> torch.Tensor:
    """Append (B, k, ...) rows to a rolling (B, T, ...) buffer, keeping T."""
    return torch.cat([buffer, new_rows.to(buffer.dtype)], dim=1)[:, new_rows.shape[1]:]


def observe(state: ControllerState, joint_state: torch.Tensor | None = None,
            imu: torch.Tensor | None = None, image: torch.Tensor | None = None,
            game_state: torch.Tensor | None = None,
            image_tokens: torch.Tensor | None = None) -> ControllerState:
    """Push one tick of sensor data: joint_state (B, J) in [-pi, pi], imu
    (B, 4|5), a preprocessed frame (B, H, W, 3) or its encoding (B, hidden)."""
    updates = {}
    if joint_state is not None:
        updates["joint_state_history"] = _roll_append(state.joint_state_history, joint_state[:, None])
    if imu is not None:
        updates["imu_history"] = _roll_append(state.imu_history, imu[:, None])
    if image is not None and state.images is not None:
        updates["images"] = _roll_append(state.images, image[:, None])
    if image_tokens is not None and state.image_tokens is not None:
        updates["image_tokens"] = _roll_append(state.image_tokens, image_tokens[:, None])
    if game_state is not None:
        updates["game_state"] = game_state
    return state.replace(**updates)


def make_controller_batch(config: ModelConfig, state: ControllerState) -> dict:
    """The model batch dict, joints shifted into [0, 2 pi). The decoder-only
    tier (no context modality) gets a zero-width ``joint_command`` (B, 0, 0)
    that carries the batch size to ``encode_context``."""
    batch: dict = {}
    if config.use_action_history:
        batch["joint_command_history"] = torch.remainder(
            state.joint_command_history + 3 * math.pi, TWO_PI)
    if config.use_joint_states:
        batch["joint_state"] = torch.remainder(state.joint_state_history + 3 * math.pi, TWO_PI)
    if config.use_imu:
        batch["rotation"] = state.imu_history
    if config.use_images:
        if state.image_tokens is not None:
            batch["image_tokens"] = state.image_tokens
        else:
            batch["image_data"] = state.images
    if config.use_gamestate:
        batch["game_state"] = state.game_state
    if not batch:
        batch["joint_command"] = state.joint_command_history.new_zeros(
            (state.joint_command_history.shape[0], 0, 0))
    return batch


def push_action_chunk(state: ControllerState, chunk: torch.Tensor) -> ControllerState:
    """Feed the predicted chunk ((B, P, J), [0, 2 pi)) back into the action
    history with the -pi shift."""
    return state.replace(
        joint_command_history=_roll_append(state.joint_command_history, chunk - math.pi))


def observe_many(state: ControllerState, joint_states: torch.Tensor | None = None,
                 imus: torch.Tensor | None = None, images: torch.Tensor | None = None,
                 image_tokens: torch.Tensor | None = None) -> ControllerState:
    """Push K ticks of sensor rows ((B, K, J) / (B, K, 4|5)) and K' frames
    ((B, K', H, W, 3)) or their encodings ((B, K', hidden)) in one buffer
    update per modality -- the result of the matching ``observe`` calls.
    Frames arrive at their own, lower rate, so K' may differ from K."""
    updates = {}
    if joint_states is not None:
        updates["joint_state_history"] = _roll_append(state.joint_state_history, joint_states)
    if imus is not None:
        updates["imu_history"] = _roll_append(state.imu_history, imus)
    if images is not None and state.images is not None:
        updates["images"] = _roll_append(state.images, images)
    if image_tokens is not None and state.image_tokens is not None:
        updates["image_tokens"] = _roll_append(state.image_tokens, image_tokens)
    return state.replace(**updates)
