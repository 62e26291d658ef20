"""Host-side realtime control driver (counterpart of
``soccerdiffusion_tpu/inference/realtime.py``).

The reference deploys as a ROS 2 node with three timers (a 50 Hz buffer
update, a 10 Hz image update and a 200 ms replan) and a trajectory player
that picks the active chunk point by wall clock. Here the robot side is an
abstract ``RobotIO`` (the built-in ``SimulatedRobotIO``, the UDP bridge of
``inference/transport.py``, or anything with the same five methods) and
the replan runs ``sample_fn(batch, noise)``, e.g.
``inference/sampler.py:make_chunk_sampler``, on the controller buffers of
``inference/controller.py``.

The replan runs in a worker thread so that the 50 Hz actuation tick does
not wait for the device: while a new chunk is sampled the player keeps
serving points of the previous one. The sampler's step loop is Python, so
the plan thread and the control loop share the interpreter: the loop
records each tick's lateness against its schedule (``tick_lateness_ms``)
beside the plan latencies. The first call of a sampler builds the CUDA
kernels (minutes with nvcc): warm it, and synchronise the device, before
``run`` (``cli serve`` does).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

import numpy as np
import torch

from soccerdiffusion_tpu_torch import DEFAULT_RESAMPLE_RATE_HZ, IMAGE_MAX_RESAMPLE_RATE_HZ
from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.inference.controller import (
    init_controller_state,
    make_controller_batch,
    observe,
    push_action_chunk,
)
from soccerdiffusion_tpu_torch.inference.player import select_action

logger = logging.getLogger("soccerdiffusion_tpu_torch")


class RobotIO(Protocol):
    """Transport seam between the driver and a robot (or simulator)."""

    def read_joint_state(self) -> Optional[np.ndarray]:
        """(J,) latest joint positions in [-pi, pi], or None."""

    def read_imu(self) -> Optional[np.ndarray]:
        """(4,) or (5,) latest orientation, or None."""

    def read_image(self) -> Optional[np.ndarray]:
        """(H, W, 3) preprocessed float frame, or None."""

    def read_game_state(self) -> Optional[int]:
        """Robot state id, or None."""

    def write_command(self, command: np.ndarray) -> None:
        """(J,) joint command in [-pi, pi]."""


@dataclass
class ChunkSlot:
    chunk: np.ndarray  # (P, J), [0, 2 pi) domain
    start_time: float


class RealtimeController:
    """The JAX controller's arguments and semantics, with the model's own
    parameters in place of ``variables`` and an explicit ``device`` (the
    card unless the caller asks for the CPU).

    ``sample_fn(batch, noise) -> (1, P, J)`` chunks in [0, 2 pi); ``noise``
    (1, P, J) is drawn from the controller's own ``torch.Generator`` on
    ``device``, seeded by ``seed``. ``encode_image_fn(frames (1, K, H, W,
    3)) -> (1, K, hidden)`` turns on the image-token cache: each frame is
    encoded once on arrival (the 10 Hz image tick) and the replan samples
    against the cached tokens."""

    def __init__(
        self,
        config: ModelConfig,
        sample_fn: Callable,
        io: RobotIO,
        control_rate_hz: float = DEFAULT_RESAMPLE_RATE_HZ,
        image_rate_hz: float = IMAGE_MAX_RESAMPLE_RATE_HZ,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        plan_in_thread: bool = True,
        replan_every_ticks: Optional[int] = None,
        plan_join_timeout_s: Optional[float] = 600.0,
        encode_image_fn: Optional[Callable] = None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = config
        self.sample_fn = sample_fn
        self.io = io
        self.control_rate = control_rate_hz
        self.image_period = 1.0 / image_rate_hz
        self.clock = clock
        self.sleep_fn = sleep_fn
        # plan_in_thread=False replans inline in the control loop (no
        # overlap): deterministic under a virtual clock, at the cost of one
        # blocked actuation tick per replan
        self.plan_in_thread = plan_in_thread
        # replan every pred_len ticks (200 ms at the default rates); fewer is
        # a receding horizon: the slot keeps the whole chunk, so actuation
        # plays on past the horizon if a plan is late, and only the horizon
        # prefix enters the action history (RolloutEngine's replan_every)
        P = config.trajectory_prediction_length
        self.replan_every_ticks = P if replan_every_ticks is None else int(replan_every_ticks)
        if not 1 <= self.replan_every_ticks <= P:
            raise ValueError(f"replan_every_ticks must be in [1, pred_len={P}], "
                             f"got {replan_every_ticks}")
        self.replan_period = self.replan_every_ticks / control_rate_hz
        self.device = torch.device(device)
        self.encode_image_fn = encode_image_fn
        cache_tokens = config.use_images and encode_image_fn is not None
        self._state = init_controller_state(config, batch_size=1, device=self.device,
                                            cache_image_tokens=cache_tokens)
        if cache_tokens:
            # the raw path's zero frames from the first replan on: prefill the
            # cache with the zero frame's encoding
            res = config.image_resolution
            with torch.no_grad():
                zero = encode_image_fn(torch.zeros((1, 1, res, res, 3), device=self.device))
            self._state = self._state.replace(image_tokens=zero.to(
                self._state.image_tokens.dtype).expand_as(self._state.image_tokens).contiguous())
        self._state_lock = threading.Lock()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._slot: Optional[ChunkSlot] = None
        self._last_image_time = -np.inf
        self._plan_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.plan_latencies_ms: list[float] = []
        self.tick_lateness_ms: list[float] = []  # each tick's start after its scheduled time
        self.overruns = 0
        self.nonfinite_chunks = 0  # plans whose chunk holds a NaN or an infinity
        self.ticks_without_chunk = 0  # ticks before the first plan's chunk arrived
        # how long run() waits for an in-flight plan after the loop ends;
        # past it the daemon thread is abandoned with an error (None: wait)
        self.plan_join_timeout_s = plan_join_timeout_s

    # ------------------------------------------------------------- plumbing

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)[None]

    @torch.no_grad()
    def _observe_tick(self, now: float) -> None:
        joint_state = self.io.read_joint_state()
        imu = self.io.read_imu()
        game_state = self.io.read_game_state()
        image = None
        if self.cfg.use_images and now - self._last_image_time >= self.image_period:
            image = self.io.read_image()
            if image is not None:
                self._last_image_time = now
        image_tokens = None
        if image is not None and self.encode_image_fn is not None:
            # encode on arrival, off the replan's critical path
            image_tokens = self.encode_image_fn(self._tensor(image)[None])[:, 0]
            image = None
        with self._state_lock:
            self._state = observe(
                self._state,
                joint_state=None if joint_state is None else self._tensor(joint_state),
                imu=None if imu is None else self._tensor(imu),
                image=None if image is None else self._tensor(image),
                game_state=(None if game_state is None
                            else torch.full((1,), int(game_state), dtype=torch.int64,
                                            device=self.device)),
                image_tokens=image_tokens,
            )

    @torch.no_grad()
    def _plan_once(self) -> None:
        t0 = self.clock()
        with self._state_lock:
            batch = make_controller_batch(self.cfg, self._state)
        shape = (1, self.cfg.trajectory_prediction_length, self.cfg.num_joints)
        noise = torch.randn(shape, generator=self._generator, device=self.device)
        chunk = self.sample_fn(batch, noise)[0].float().cpu().numpy()  # waits for the device
        self.nonfinite_chunks += int(not np.isfinite(chunk).all())
        with self._state_lock:
            self._state = push_action_chunk(
                self._state, self._tensor(chunk[: self.replan_every_ticks]))
        self._slot = ChunkSlot(chunk=chunk, start_time=self.clock())
        self.plan_latencies_ms.append((self.clock() - t0) * 1e3)

    def _maybe_replan(self) -> None:
        if not self.plan_in_thread:
            self._plan_once()
            return
        if self._plan_thread is not None and self._plan_thread.is_alive():
            return  # the previous plan is still in flight: keep playing the old chunk
        self._plan_thread = threading.Thread(target=self._plan_once, daemon=True)
        self._plan_thread.start()

    def _actuate(self, now: float) -> None:
        if self._slot is None:
            self.ticks_without_chunk += 1
            return
        command = select_action(self._slot.chunk, self._slot.start_time, now, self.control_rate)
        # chunks live in [0, 2 pi); commands go out in [-pi, pi]
        self.io.write_command(command - np.pi)

    # ------------------------------------------------------------------ run

    def run(self, duration_s: float) -> None:
        """Blocking control loop at ``control_rate`` for ``duration_s``."""
        period = 1.0 / self.control_rate
        start = self.clock()
        next_tick = start
        next_plan = start
        while not self._stop.is_set() and self.clock() - start < duration_s:
            now = self.clock()
            self.tick_lateness_ms.append((now - next_tick) * 1e3)
            self._observe_tick(now)
            if now >= next_plan:
                self._maybe_replan()
                next_plan += self.replan_period
            self._actuate(now)
            next_tick += period
            sleep = next_tick - self.clock()
            if sleep > 0:
                self.sleep_fn(sleep)
            elif sleep < -period:
                logger.warning(f"control loop overran by {-sleep * 1e3:.1f} ms")
                self.overruns += 1
                next_tick = self.clock()
        if self._plan_thread is not None:
            self._plan_thread.join(timeout=5.0)
            if self._plan_thread.is_alive():
                # an in-flight plan may outlive the loop (a first call that
                # builds the kernels); wait it out, up to the bound
                logger.warning("waiting for the in-flight plan to finish (a first call that "
                               "builds the kernels?)")
                self._plan_thread.join(timeout=self.plan_join_timeout_s)
                if self._plan_thread.is_alive():
                    logger.error(f"in-flight plan still running after "
                                 f"{self.plan_join_timeout_s:.0f}s; abandoning the plan thread")

    def stop(self) -> None:
        self._stop.set()


class SimulatedRobotIO:
    """Built-in plant for driver tests and demos: first-order joint tracking."""

    def __init__(self, num_joints: int, imu_dim: int = 4, alpha: float = 0.5):
        self.positions = np.zeros(num_joints, dtype=np.float32)
        self.imu_dim = imu_dim
        self.alpha = alpha
        self.commands_received: int = 0

    def read_joint_state(self):
        return self.positions

    def read_imu(self):
        imu = np.zeros(self.imu_dim, dtype=np.float32)
        imu[-1] = 1.0
        return imu

    def read_image(self):
        return None

    def read_game_state(self):
        return 2

    def write_command(self, command: np.ndarray) -> None:
        self.commands_received += 1
        self.positions = self.positions + self.alpha * (
            command.astype(np.float32) - self.positions)
