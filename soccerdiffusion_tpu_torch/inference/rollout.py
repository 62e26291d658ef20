"""Batched closed-loop rollout engine (counterpart of
``soccerdiffusion_tpu/inference/rollout.py``).

One replan period: build the batch from the controller buffers, encode the
context once, sample a chunk (30-step DDIM / DPM-Solver++, or the 1-step
distilled student), feed the executed prefix back into the action history,
play the plant over it in closed form and observe. With ``fused="chunk"``
and ``fused_encoder=True`` (the proprioceptive serving path) a period is two
kernel launches: the fused context encoder and the whole-chunk sampler.
Under ``torch.profiler`` the period's three stages are spans
(``utils/profiling.py:span``): ``sd.rollout.encode`` (the batch and the
context, the null-modality context too under guidance),
``sd.rollout.sample`` (the steps table, the K/V, the sampler, the
denormalised chunk and its executed prefix) and ``sd.rollout.feedback``
(the buffers, the plant, the stub camera and its frame tokens); the noise
draw lies outside them.

Image configs add the stub camera: one frame per 5 plant ticks (10 Hz at the
50 Hz control rate). With the image-token cache (the default for image
configs) each period encodes only the frames that arrived through the
per-frame image encoder (the ViT: one fused-block launch per block) and
rolls their tokens into the controller; the context then runs only the
frame-sequence encoder over the cached tokens. Without it the raw frames
roll in, and every period re-encodes the whole frame stack.

With ``guidance_scale`` != 1 the plain iterative sampler serves with
classifier-free guidance: the conditional context and the context with
``guidance_null``'s modalities nulled (``data/pipeline.py:null_modalities``),
both through the same encoder, are stacked along the batch, their K/V
projected once, and each step is one doubled-batch denoiser pass combined
as eps_u + w (eps_c - eps_u). The engine refuses guidance with the distilled
student or a fused sampler, and image guidance against the image-token
cache (the null is the zero frame, not a zero encoding), as the JAX engine
does.

The engine serves in eval mode (``model.eval()`` for each period and for
the zero-frame prefill, the caller's mode restored after), so the ResNets'
BatchNorm uses its running statistics, as the JAX engine's ``train=False``
applies do; a model left in train mode by the trainer serves the same.

The plant is the JAX engine's first-order joint-tracking stub; it measures
serving capacity, it is not a physics simulator.

Fleet scale-out (``make_sharded_rollout``): the robots split over a mesh
axis, each rank runs its own engine (the fused kernels on its card) on its
shard with no collective inside a period, its chunk noise from a generator
folded from the replicated one and its rank (``fold_in``), and the chunks
are all-gathered at the end. A model split by tensor parallelism is not
served.
"""

from __future__ import annotations

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
from soccerdiffusion_tpu_torch.data.pipeline import null_modalities
from soccerdiffusion_tpu_torch.inference.controller import (
    ControllerState,
    init_controller_state,
    make_controller_batch,
    observe_many,
    push_action_chunk,
)
from soccerdiffusion_tpu_torch.inference.sampler import check_guidance, eval_mode, guided_denoise_fn
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
from soccerdiffusion_tpu_torch.parallel import comm
from soccerdiffusion_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class PlantState:
    positions: torch.Tensor  # (B, J) joint positions, [-pi, pi] domain
    phase: torch.Tensor  # (B,) sinusoid phase of the IMU stub


@dataclass(frozen=True)
class RolloutCarry:
    controller: ControllerState
    plant: PlantState
    generator: torch.Generator  # chunk noise


def fold_in(generator: torch.Generator, index: int) -> torch.Generator:
    """A generator for shard ``index``, on ``generator``'s device, seeded from
    one draw of ``generator`` and ``index`` (the counterpart of
    ``jax.random.fold_in`` on the replicated key). ``generator`` advances by
    that one draw, alike on every rank that holds the same one, so that
    the next call folds fresh seeds."""
    draw = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    words = np.random.SeedSequence([draw, int(index)]).generate_state(2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=generator.device).manual_seed(seed)


def largest_dividing_block(configured: int, batch: int) -> int:
    """The largest block size <= ``configured`` that divides ``batch`` (the
    JAX engine's rule for the fused samplers' robot blocks)."""
    block = min(configured, batch)
    while batch % block:
        block -= 1
    return block


def _rows(value, start: int, stop: int):
    return None if value is None else value[start:stop]


class RolloutEngine:
    """Same arguments as the JAX engine, plus ``device``: the card unless the
    caller asks for the CPU (whose tensors take the kernels' plain versions).

    The engine packs the model's weights for the fused kernels when it is
    built, so load the weights first. ``fused_kv_quant="int8"`` serves the
    chunk sampler's int8 context K/V form over blocks of
    ``largest_dividing_block(fused_block_robots, B)`` robots, which share
    its quantisation scales, as the JAX engine does; ``fused_group_robots``
    computes the ungrouped function (``ops/fused_chunk.py``), and with int8
    K/V it must be 1. Otherwise ``fused_block_robots``,
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
        if getattr(model, "tensor_parallel", None) is not None:
            raise ValueError("the engine serves whole weights; a model split by tensor "
                             "parallelism is not served (load its checkpoint into a new model)")
        if param.device.type != self.device.type:
            raise ValueError(f"the model's parameters are on {param.device}, the engine's "
                             f"device is {self.device}: move the model first")
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
        self.fused_block_robots, self.fused_group_robots = fused_block_robots, fused_group_robots
        self.fused_encoder = bool(fused_encoder)
        self.solver = solver
        # per-frame image encodings computed once per frame arrival and
        # rolled in the controller (default on for image configs)
        self.cache_image_tokens = (self.cfg.use_images if cache_image_tokens is None
                                   else bool(cache_image_tokens))
        self.guidance_scale = float(guidance_scale)
        self.guidance_null = tuple(guidance_null)
        if self.guidance_scale != 1.0 and (distilled or fused):
            raise ValueError("guidance_scale != 1 requires the plain iterative sampler "
                             "(fused=False, distilled=False)")
        if (self.guidance_scale != 1.0 and self.cache_image_tokens and self.cfg.use_images
                and ("image" in self.guidance_null or "all" in self.guidance_null)):
            raise ValueError("image-modality guidance cannot run against the image-token cache "
                             "(tokens are encodings, the null is the zero FRAME); pass "
                             "cache_image_tokens=False")
        check_guidance(self.cfg, self.guidance_scale, self.guidance_null)
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
            check_serving_supported(fused_group_robots, fused_kv_quant)
            self._sampler_op = FusedChunkSampler(model, block_robots=fused_block_robots,
                                                 context_kv_quant=fused_kv_quant)
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

    def _encode_context(self, controller: ControllerState) -> torch.Tensor:
        """The context of the controller's batch (B, S, hidden); with
        guidance, the null-modality context stacked under it (2B, S, hidden)."""
        batch = make_controller_batch(self.cfg, controller)
        op = self._encoder_op
        encode = op.encode if op is not None else self.model.encode_context
        context = encode(batch)
        if self.guidance_scale != 1.0:
            # both branches through the same encoder, so that no encoder
            # difference leaks into eps_c - eps_u
            null = encode(null_modalities(batch, self.guidance_null))
            context = torch.cat([context, null], dim=0)
        return context

    def _sample_chunk(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        model, n, bsz = self.model, self.num_inference_steps, noise.shape[0]
        if self.distilled and self.fused:
            # one pass at t=0: the student's output is the trajectory
            packed = self._sampler_op.pack_context_kv(model.precompute_context_kv(context))
            traj = self._sampler_op(packed, noise, self._steps_table(np.zeros(1))[0])
        elif self.distilled:
            traj = model.denoise(context, noise,
                                 torch.zeros((bsz,), dtype=torch.int64, device=self.device))
        elif self.fused == "chunk":
            ts = solver_timesteps(self.schedule, n, parse_solver(self.solver)[1])
            # the JAX engine's robot block, fitted to the batch
            block = largest_dividing_block(self.fused_block_robots, bsz)
            traj = self._sampler_op.sample(context, noise, self._steps_table(ts), self.schedule, n,
                                           solver=self.solver, block_robots=block)
        elif self.fused:
            packed = self._sampler_op.pack_context_kv(model.precompute_context_kv(context))
            ts = ddim_timesteps(self.schedule.num_train_timesteps, n)
            traj = self._sampler_op.sample(packed, noise, self._steps_table(ts), self.schedule, n)
        elif self.guidance_scale != 1.0:
            denoise_fn = guided_denoise_fn(model, model.precompute_context_kv(context), bsz,
                                           self.guidance_scale)
            traj = solver_sample(self.schedule, denoise_fn, noise, n, solver=self.solver)
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
        noise = noise.to(self.device, torch.float32)
        # the stages, each a top-level span of a torch.profiler trace
        with span("sd.rollout.encode"):
            context = self._encode_context(carry.controller)
        with span("sd.rollout.sample"):
            executed = self._sample_chunk(context, noise)[:, : self.replan_every]
        with span("sd.rollout.feedback"):
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

    def shard_carry(self, carry: RolloutCarry, mesh, axis: str = "data") -> RolloutCarry:
        """This rank's robots of a fleet-wide carry: the rows of its index
        over ``axis`` (the robots must split evenly); the generator is kept."""
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        b = carry.plant.positions.shape[0]
        if b % n:
            raise ValueError(f"{b} robots do not split over the {n} ranks of {axis!r}")
        lo, hi = i * (b // n), (i + 1) * (b // n)
        c = carry.controller
        controller = c.replace(**{f: _rows(getattr(c, f), lo, hi) for f in (
            "joint_command_history", "joint_state_history", "imu_history", "game_state",
            "images", "image_tokens")})
        plant = PlantState(positions=carry.plant.positions[lo:hi], phase=carry.plant.phase[lo:hi])
        return RolloutCarry(controller=controller, plant=plant, generator=carry.generator)

    def make_sharded_rollout(self, num_chunks: int, mesh, axis: str = "data"):
        """Fleet scale-out: ``rollout(carry) -> (carry, chunks)`` on this
        rank's shard of the robots (``shard_carry``), ``num_chunks`` replan
        periods of this rank's engine with no collective inside them; the
        chunks come back gathered over ``axis`` to (num_chunks, B,
        replan_every, J) on every rank (the JAX ``make_sharded_rollout_fn``).

        The shard's chunk noise comes from ``fold_in(carry.generator,
        rank's index over axis)``: each shard is bit-identical to an
        unsharded rollout over its robots with that generator. The
        returned carry is the shard's, with the replicated generator,
        advanced by one draw, so that repeated calls fold fresh noise."""
        base = self.make_rollout_fn(num_chunks)
        group, index = mesh.group(axis), mesh.axis_index(axis)

        def rollout(carry: RolloutCarry):
            shard = RolloutCarry(controller=carry.controller, plant=carry.plant,
                                 generator=fold_in(carry.generator, index))
            out, chunks = base(shard)
            out = RolloutCarry(controller=out.controller, plant=out.plant,
                               generator=carry.generator)
            return out, comm.all_gather(chunks, group, dim=1)

        return rollout
