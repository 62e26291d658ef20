"""Batched closed-loop rollout engine (counterpart of
``soccerdiffusion_tpu/inference/rollout.py``).

One replan period: build the batch from the controller buffers, encode the
context once, sample a chunk (30-step DDIM / DPM-Solver++, or the 1-step
distilled student), feed the executed prefix back into the action history,
play the plant over it in closed form and observe. With ``fused="chunk"``
and ``fused_encoder=True`` (the proprioceptive serving path) a period is two
kernel launches: the fused context encoder and the whole-chunk sampler.

Image configs add the stub camera: one frame per 5 plant ticks (10 Hz at the
50 Hz control rate). With the image-token cache (the default for image
configs) each period encodes only the frames that arrived through the
per-frame image encoder (the ViT: one fused-block launch per block) and
rolls their tokens into the controller; the context then runs only the
frame-sequence encoder over the cached tokens. Without it the raw frames
roll in, and every period re-encodes the whole frame stack.

The engine serves in eval mode (``model.eval()`` for each period and for
the zero-frame prefill, the caller's mode restored after), so the ResNets'
BatchNorm uses its running statistics, as the JAX engine's ``train=False``
applies do; a model left in train mode by the trainer serves the same.

The plant is the JAX engine's first-order joint-tracking stub; it measures
serving capacity, it is not a physics simulator.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig, check_serving_supported
from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.diffusion import (
    DiffusionSchedule,
    ddim_timesteps,
    parse_solver,
    solver_sample,
    solver_timesteps,
)
from soccerdiffusion_tpu_torch.inference.controller import (
    ControllerState,
    init_controller_state,
    make_controller_batch,
    observe_many,
    push_action_chunk,
)
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """``model`` in eval mode inside the block, its own mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


@dataclass(frozen=True)
class PlantState:
    positions: torch.Tensor  # (B, J) joint positions, [-pi, pi] domain
    phase: torch.Tensor  # (B,) sinusoid phase of the IMU stub


@dataclass(frozen=True)
class RolloutCarry:
    controller: ControllerState
    plant: PlantState
    generator: torch.Generator  # chunk noise


class RolloutEngine:
    """Same arguments as the JAX engine, plus ``device``: the card unless the
    caller asks for the CPU (whose tensors take the kernels' plain versions).

    The engine packs the model's weights for the fused kernels when it is
    built, so load the weights first. ``fused_block_robots``,
    ``fused_encoder_block_robots`` and ``fused_interpret`` are accepted for
    the JAX signature and have no effect: the CUDA kernels run one thread
    block per robot (a CUDA grid masks its own ragged edge, so no block
    size has to divide the batch), and CPU tensors take the kernels' plain
    versions. ``fused_encoder="interpret"`` means True."""

    def __init__(self, model, schedule: DiffusionSchedule, normalizer: Normalizer,
                 num_inference_steps: int = 30, distilled: bool = False,
                 tracking_alpha: float = 0.5, fused: bool | str = False,
                 fused_block_robots: int = 8, fused_group_robots: int = 1,
                 fused_encoder: bool | str = False, fused_encoder_block_robots: int = 16,
                 fused_kv_quant: str = "none", replan_every: int | None = None,
                 solver: str = "ddim", fused_interpret: bool = False,
                 guidance_scale: float = 1.0, guidance_null: tuple[str, ...] = ("image",),
                 cache_image_tokens: bool | None = None, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} requested but CUDA is not available")
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"the model's parameters are on {param.device}, the engine's "
                             f"device is {self.device}: move the model first")
        check_serving_supported(group_robots=fused_group_robots, kv_quant=fused_kv_quant,
                                guidance_scale=guidance_scale)
        if fused not in (False, True, "step", "chunk"):
            raise ValueError(f"unknown fused mode {fused!r}")
        parse_solver(solver)
        if solver != "ddim" and (distilled or fused is True or fused == "step"):
            raise ValueError("solver='dpmpp' is supported on the plain sampler and the fused "
                             "'chunk' kernel; distilled students and the per-step fused "
                             "denoiser are DDIM-only")
        self.model = model
        self.cfg: ModelConfig = model.config
        self.schedule = schedule
        self.normalizer = normalizer.to(self.device)  # one copy, not one per period
        self.num_inference_steps = num_inference_steps
        self.distilled = distilled
        self.tracking_alpha = tracking_alpha
        self.fused = fused
        self.fused_encoder = bool(fused_encoder)
        self.solver = solver
        # per-frame image encodings computed once per frame arrival and
        # rolled in the controller (default on for image configs)
        self.cache_image_tokens = (self.cfg.use_images if cache_image_tokens is None
                                   else bool(cache_image_tokens))
        P = self.cfg.trajectory_prediction_length
        self.replan_every = P if replan_every is None else int(replan_every)
        if not 1 <= self.replan_every <= P:
            raise ValueError(f"replan_every must be in [1, pred_len={P}], got {replan_every}")
        if self.cfg.use_images and self.replan_every % 5 != 0:
            raise ValueError(
                "image configs need replan_every to be a multiple of 5 ticks so the 10 Hz stub "
                "camera (one frame per 5 ticks at 50 Hz) stays on schedule across replan "
                f"periods; got replan_every={replan_every}")
        if self.fused_encoder and self.cfg.use_images:
            raise ValueError(
                "fused_encoder covers the proprioceptive encoder stacks only; image configs "
                "must use the model's context encoder (fused_encoder=False)")
        self._encoder_op = FusedContextEncoder(model) if self.fused_encoder else None
        if fused == "chunk" and not distilled:
            self._sampler_op = FusedChunkSampler(model)
        elif fused:
            self._sampler_op = FusedDenoiser(model)
        else:
            self._sampler_op = None

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init(self, batch_size: int, generator: torch.Generator,
             prefill: bool = True) -> RolloutCarry:
        """``generator`` draws the chunk noise; it must live on the engine's
        device. With the image-token cache, ``prefill`` fills the token
        buffer with the zero-frame encoding, which the raw path's zero
        frames give from the first replan on (the JAX engine's ``init``
        with ``variables``); without it the cache starts at zero tokens."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, engine on {self.device}")
        J = self.cfg.num_joints
        phase = torch.from_numpy(np.linspace(0.0, 2 * np.pi, batch_size, endpoint=False)
                                 .astype(np.float32)).to(self.device)
        controller = init_controller_state(self.cfg, batch_size, device=self.device,
                                           cache_image_tokens=self.cache_image_tokens)
        if controller.image_tokens is not None and prefill:
            res = self.cfg.image_resolution
            with eval_mode(self.model):
                zero = self.model.encode_image_frames(
                    torch.zeros((1, 1, res, res, 3), device=self.device))  # (1, 1, hidden)
            controller = controller.replace(image_tokens=zero.to(torch.float32).expand_as(
                controller.image_tokens).contiguous())
        return RolloutCarry(
            controller=controller,
            plant=PlantState(positions=torch.zeros((batch_size, J), device=self.device),
                             phase=phase),
            generator=generator)

    # ----------------------------------------------------------- one replan

    def _steps_table(self, timesteps: np.ndarray) -> torch.Tensor:
        ts = torch.as_tensor(timesteps.astype(np.int64), device=self.device)
        return self.model.step_encoding(ts)[:, 0]  # (T, E)

    def _sample_chunk(self, controller: ControllerState, noise: torch.Tensor) -> torch.Tensor:
        model, n = self.model, self.num_inference_steps
        batch = make_controller_batch(self.cfg, controller)
        if self._encoder_op is not None:
            context = self._encoder_op.encode(batch)
        else:
            context = model.encode_context(batch)
        bsz = context.shape[0]
        if self.distilled and self.fused:
            # one pass at t=0: the student's output is the trajectory
            packed = self._sampler_op.pack_context_kv(model.precompute_context_kv(context))
            traj = self._sampler_op(packed, noise, self._steps_table(np.zeros(1))[0])
        elif self.distilled:
            traj = model.denoise(context, noise,
                                 torch.zeros((bsz,), dtype=torch.int64, device=self.device))
        elif self.fused == "chunk":
            ts = solver_timesteps(self.schedule, n, parse_solver(self.solver)[1])
            traj = self._sampler_op.sample(context, noise, self._steps_table(ts), self.schedule,
                                           n, solver=self.solver)
        elif self.fused:
            packed = self._sampler_op.pack_context_kv(model.precompute_context_kv(context))
            ts = ddim_timesteps(self.schedule.num_train_timesteps, n)
            traj = self._sampler_op.sample(packed, noise, self._steps_table(ts), self.schedule, n)
        else:
            context_kv = model.precompute_context_kv(context)

            def denoise_fn(x, t):
                steps = torch.full((bsz,), t, dtype=torch.int64, device=self.device)
                return model.denoise_with_kv(context_kv, x, steps)

            traj = solver_sample(self.schedule, denoise_fn, noise, n, solver=self.solver)
        return self.normalizer.denormalize(traj)  # [0, 2 pi) domain

    def _plant_play_chunk(self, plant: PlantState, chunk: torch.Tensor):
        """All ticks of the (prefix of the) chunk in closed form: the tracking
        recurrence p_{k+1} = p_k + a (t_k - p_k) is linear, so every tick's
        position is one (P, P) lower-triangular product plus a decayed
        initial-state term. Returns (plant, joint_state rows, imu rows)."""
        P = chunk.shape[1]
        a = self.tracking_alpha
        beta = 1.0 - a
        k = np.arange(1, P + 1)
        j = np.arange(P)
        decay = torch.as_tensor(beta ** k, dtype=chunk.dtype, device=chunk.device)
        m = np.where(j[None, :] <= k[:, None] - 1, a * beta ** (k[:, None] - 1 - j[None, :]), 0.0)
        m = torch.as_tensor(m, dtype=chunk.dtype, device=chunk.device)
        targets = chunk - math.pi
        positions = (decay[None, :, None] * plant.positions[:, None, :]
                     + torch.einsum("pk,bkj->bpj", m, targets))
        phases = plant.phase[:, None] + torch.as_tensor(0.02 * k, dtype=torch.float32,
                                                        device=chunk.device)[None, :]
        if self.cfg.imu_input_dim == 4:
            half = 0.05 * torch.sin(phases)
            z = torch.zeros_like(half)
            imus = torch.stack([torch.sin(half), z, z, torch.cos(half)], dim=-1)
        else:
            angle = 0.1 * torch.sin(phases)
            ones, z = torch.ones_like(angle), torch.zeros_like(angle)
            imus = torch.stack([ones, z, z, torch.sin(angle), torch.cos(angle)], dim=-1)
        return PlantState(positions=positions[:, -1], phase=phases[:, -1]), positions, imus

    def _camera_frames(self, plant: PlantState) -> torch.Tensor:
        """The stub camera's frames of one period, (B, n, res, res, 3): frame i
        of n lands on tick P-1-5(n-1-i), at that tick's phase; a cheap
        phase-dependent gradient at ImageNet-normalised scale."""
        n = max(1, self.replan_every // 5)
        res = self.cfg.image_resolution
        ramp = torch.linspace(-1.0, 1.0, res, device=self.device)
        offsets = torch.as_tensor(0.02 * 5.0 * np.arange(n - 1, -1, -1), dtype=torch.float32,
                                  device=self.device)
        ph = (plant.phase[:, None] - offsets)[:, :, None, None, None]
        base = ramp[None, None, :, None, None] + ramp[None, None, None, :, None]
        frames = torch.sin(base + ph).expand(ph.shape[0], n, res, res, 1)
        return frames.repeat(1, 1, 1, 1, 3)

    @torch.no_grad()
    def replan_period(self, carry: RolloutCarry,
                      noise: torch.Tensor | None = None) -> tuple[RolloutCarry, torch.Tensor]:
        """Sample a chunk, play its first ``replan_every`` ticks and feed the
        observations back. ``noise`` (B, P, J) fp32 replaces the draw from
        the carry's generator. Returns the executed prefix (B, replan_every, J)."""
        with eval_mode(self.model):
            return self._replan_period(carry, noise)

    def _replan_period(self, carry: RolloutCarry,
                       noise: torch.Tensor | None) -> tuple[RolloutCarry, torch.Tensor]:
        if noise is None:
            b = carry.plant.positions.shape[0]
            shape = (b, self.cfg.trajectory_prediction_length, self.cfg.num_joints)
            noise = torch.randn(shape, generator=carry.generator, device=self.device)
        chunk = self._sample_chunk(carry.controller, noise.to(self.device, torch.float32))
        executed = chunk[:, : self.replan_every]
        controller = push_action_chunk(carry.controller, executed)
        plant, js_rows, imu_rows = self._plant_play_chunk(carry.plant, executed)
        frames = tokens = None
        if self.cfg.use_images:
            frames = self._camera_frames(plant)
            if controller.image_tokens is not None:
                # the token cache: encode only the frames that arrived
                tokens, frames = self.model.encode_image_frames(frames), None
        controller = observe_many(controller, joint_states=js_rows, imus=imu_rows,
                                  images=frames, image_tokens=tokens)
        return RolloutCarry(controller=controller, plant=plant, generator=carry.generator), executed

    # --------------------------------------------------------------- rollout

    def make_rollout_fn(self, num_chunks: int):
        """``rollout(carry) -> (carry, chunks)`` over ``num_chunks`` replan
        periods; chunks is (num_chunks, B, replan_every, J)."""

        def rollout(carry: RolloutCarry):
            chunks = []
            for _ in range(num_chunks):
                carry, executed = self.replan_period(carry)
                chunks.append(executed)
            return carry, torch.stack(chunks)

        return rollout
