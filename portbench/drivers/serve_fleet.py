"""Closed-loop fleet serving: ``robots`` robots, each replanning a chunk
every ``replan_every`` ticks through ``RolloutEngine.replan_period``, the
executed part of every chunk copied to a pinned host buffer (a deployment
commands the joints from there), the next period started when it is there.

Cell parameters (``workloads/<cell>.json``): ``robots``, ``steps`` (DDIM
steps; 1 for the distilled student), ``distilled``, ``fused``,
``fused_encoder``, ``replan_every``, ``tracking_alpha``, ``warmup_periods``
(set-up; at least 5 so that a camera robot's frame tokens are all from the
stub camera), ``trace_periods``, ``check_periods`` (the periods of the
window that the reference recomputes, drawn from the seed) and
``reference_rows`` (the block of robots the reference computes at once).

What is compared, once the window has closed and the program is freed:
  * ``chunk_gap``: for each checked period, the largest gap between the
    program's executed chunk and the reference's from the same state and
    noise, in units of the joint's normaliser scale, over the largest
    normalised value of the reference's; the largest over the periods. The
    reference recomputes the context (and a camera robot's frame tokens,
    from the stub camera at the plant's phase) and the sampler.
  * ``loop_gap``: the buffers and plant the program left after each checked
    period against the reference's update of the state before it with the
    program's executed chunk (the stage the chunk check takes from the
    program), relative to each buffer's scale.
  * ``start_gap``: the engine's initial state against the reference's.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import harness, work
from portbench.reference import policy as ref


# what ``run.run_cell(side=...)`` may judge besides the program: the reference in
# float8 in the program's place, and the faults planted under the timed path
CONTROLS = ("fp8",)
FAULTS = ("unchanged", "half_batch", "altered")


def _scale(t: torch.Tensor) -> float:
    return max(float(t.abs().max()), 1.0)


class Driver:
    unit = "period"

    def __init__(self, cell: dict, conf: dict, seed: int, device, fault: str | None = None):
        self.cell, self.conf, self.cfg = cell, conf, conf["model"]
        self.device = torch.device(device)
        self.fault = fault
        self.w_seed, self.n_seed, self.noise_seed, self.pick_seed = harness.seeds(seed, 4)
        self.frames_per_period = (cell["replan_every"] // 5) if self.cfg["use_images"] else 0

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from soccerdiffusion_tpu_torch.config import ModelConfig
        from soccerdiffusion_tpu_torch.data import Normalizer
        from soccerdiffusion_tpu_torch.diffusion import make_schedule
        from soccerdiffusion_tpu_torch.inference import RolloutEngine
        from soccerdiffusion_tpu_torch.models import DiffusionPolicy

        c, dev = self.cell, self.device
        model = DiffusionPolicy(ModelConfig(**self.cfg)).to(dev)
        self.weights = harness.make_weights(model, self.w_seed, dev)
        g = torch.Generator(device=dev).manual_seed(self.n_seed)
        u = torch.rand((2, self.cfg["num_joints"]), generator=g, device=dev)
        self.norm_mean, self.norm_std = 2.6 + 1.1 * u[0], 0.3 + 0.6 * u[1]
        normalizer = Normalizer(mean=self.norm_mean.clone(), std=self.norm_std.clone())
        self.engine = RolloutEngine(
            model.eval(), make_schedule(self.conf["train"]["train_denoising_timesteps"]), normalizer,
            num_inference_steps=c["steps"], distilled=c["distilled"],
            tracking_alpha=c["tracking_alpha"], fused=c["fused"], fused_encoder=c["fused_encoder"],
            replan_every=c["replan_every"], device=dev)
        self.noise_gen = torch.Generator(device=dev).manual_seed(self.noise_seed)
        self.host, self.nonfinite = None, torch.zeros((), dtype=torch.int64, device=dev)
        self.carry = self.start = self.engine.init(c["robots"], torch.Generator(device=dev))
        for _ in range(c["warmup_periods"]):
            self.period()

    def unit_flops(self) -> float:
        """Model FLOPs of one period of the fleet."""
        return self.cell["robots"] * work.serve_period_flops(self.cfg, self.cell["steps"],
                                                             self.frames_per_period)

    # ------------------------------------------------------------ the path

    def period(self):
        """One replan period: the noise drawn, the period served, the
        executed chunk on the host. Returns (state before, noise, executed,
        state after)."""
        c = self.cell
        shape = (c["robots"], self.cfg["trajectory_prediction_length"], self.cfg["num_joints"])
        noise = torch.randn(shape, generator=self.noise_gen, device=self.device)
        before = self.carry
        after, executed = self.engine.replan_period(before, noise)
        if self.fault == "unchanged":  # the state comes back as it went in
            after = before
        elif self.fault == "half_batch":  # half the robots served, the rest copied
            half = executed.shape[0] // 2
            executed = torch.cat([executed[:half], executed[:executed.shape[0] - half]])
        elif self.fault == "altered":  # two robots' answers swapped where produced
            executed = executed.clone()
            executed[[0, 1]] = executed[[1, 0]]
        # the consumer: the executed chunk into a pinned host buffer, waited for
        if self.host is None:
            self.host = torch.empty(executed.shape, dtype=executed.dtype,
                                    pin_memory=self.device.type == "cuda")
        self.host.copy_(executed, non_blocking=True)
        self.sync()
        self.nonfinite.add_((~torch.isfinite(executed)).any())
        self.carry = after
        return before, noise, executed, after

    def window(self, seconds: float) -> dict:
        """Periods until ``seconds`` have passed; the window ends at the last
        period's copy. A seeded reservoir keeps ``check_periods`` of them."""
        rng = np.random.default_rng(self.pick_seed)
        keep, kept = self.cell["check_periods"], []
        lat, n = [], 0
        self.nonfinite.zero_()
        self.sync()
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            record = self.period()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if n < keep:
                kept.append(record)
            else:
                j = int(rng.integers(0, n + 1))
                if j < keep:
                    kept[j] = record
            n += 1
            if t1 - t_start >= seconds:
                break
        self.kept = kept
        elapsed = t1 - t_start
        failed = int(self.nonfinite)  # periods whose chunk was not finite
        return {"t_start": t_start, "seconds": elapsed, "units": n, "attempted": n, "failed": failed,
                "metrics": {"chunks_per_s": self.cell["robots"] * n / elapsed,
                            "period_ms_p95": 1e3 * harness.percentile(lat, 95)}}

    def traced(self, periods: int) -> None:
        for _ in range(periods):
            self.period()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        """Free the program: the engine and its model. The kept periods'
        states and answers stay for the check."""
        self.engine = None
        self.carry = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _ref_chunks(self, state: dict, noise, prec: str) -> torch.Tensor:
        cfg, c = self.cfg, self.cell
        rows = c["reference_rows"]
        out = []
        for lo in range(0, noise.shape[0], rows):
            part = {k: v[lo: lo + rows] for k, v in state.items()}
            batch = ref.model_batch(part)
            tokens = None
            if cfg["use_images"]:
                f, res = cfg["image_context_length"], cfg["image_resolution"]
                phases = ref.frame_phases(part["phase"], f, self.frames_per_period)
                frames = ref.camera_frames(phases, res).reshape(-1, res, res, 3)
                pix = ref.patchify(frames, cfg["vit_patch_size"])
                tokens = ref.vit_frames(self.weights, cfg, pix, prec).reshape(phases.shape[0], f, -1)
            ctx = ref.context(self.weights, cfg, batch, prec, tokens)
            chunk = ref.sample_chunk(self.weights, cfg, ctx, noise[lo: lo + rows], self.norm_mean,
                                     self.norm_std, c["steps"], c["distilled"], prec)
            out.append(chunk[:, : c["replan_every"]])
        return torch.cat(out)

    @staticmethod
    def _state(carry) -> dict:
        ctl, plant = carry.controller, carry.plant
        return {"joint_command_history": ctl.joint_command_history,
                "joint_state_history": ctl.joint_state_history, "imu_history": ctl.imu_history,
                "game_state": ctl.game_state, "positions": plant.positions, "phase": plant.phase}

    def _chunk_gap(self, got, want) -> float:
        std, mean = self.norm_std, self.norm_mean
        scale = float(((want - mean) / std).abs().max())
        return float(((got.float() - want) / std).abs().max()) / max(scale, 1e-30)

    def check(self, controls: tuple = ()) -> dict:
        """{"program": {number: reading}, control: {...}} (module docstring)."""
        ref.exact_float32()
        cfg, c = self.cfg, self.cell
        imu_dim = work.imu_dim(cfg)
        readings = {"program": {"chunk_gap": 0.0, "loop_gap": 0.0}}
        for name in controls:
            readings[name] = {"chunk_gap": 0.0}
        with torch.no_grad():
            for before, noise, executed, after in self.kept:
                state = self._state(before)
                want = self._ref_chunks(state, noise, "fp32")
                r = readings["program"]
                r["chunk_gap"] = max(r["chunk_gap"], self._chunk_gap(executed, want))
                for name in controls:
                    got = self._ref_chunks(state, noise, name)
                    readings[name]["chunk_gap"] = max(readings[name]["chunk_gap"],
                                                      self._chunk_gap(got, want))
                upd = ref.controller_update(state, executed[:, : c["replan_every"]],
                                            c["tracking_alpha"], imu_dim)
                got_after = self._state(after)
                for key, value in upd.items():
                    gap = float((got_after[key].float() - value.float()).abs().max()) / _scale(value)
                    r["loop_gap"] = max(r["loop_gap"], gap)
            s = self._state(self.start)
            b, j = c["robots"], cfg["num_joints"]
            zeros = lambda *shape: torch.zeros(shape, device=s["phase"].device)
            phase = torch.from_numpy(np.linspace(0.0, 2 * math.pi, b, endpoint=False)
                                     .astype(np.float32)).to(s["phase"].device)
            want0 = {"joint_command_history": zeros(b, cfg["action_context_length"], j),
                     "joint_state_history": zeros(b, cfg["joint_state_context_length"], j),
                     "imu_history": zeros(b, cfg["imu_context_length"], imu_dim),
                     "game_state": torch.full((b,), 2.0, device=phase.device),
                     "positions": zeros(b, j), "phase": phase}
            readings["program"]["start_gap"] = max(
                float((s[k].float() - v).abs().max()) / _scale(v) for k, v in want0.items())
        return readings
