"""Training steps: ``TrainStep.__call__`` on the configuration's model and
the trainer's AdamW (``make_optimizer`` as ``training/train.py`` builds it),
over a pool of ``pool`` batches made on the device from the seed and
cycled, dispatched ahead; the window ends with one sync.

Cell parameters (``workloads/<cell>.json``): ``batch``, ``pool``,
``total_steps`` (the one-cycle schedule's length), ``warmup_steps`` (set-up;
the first three are the checked steps), ``trace_steps``,
``invalid_frames`` (the share of frame slots marked invalid, as at the
start of a recording) and ``reference_rows`` (the block of rows the
reference computes at once).

Set-up drives the step from the seed through its first steps on the pool's
first batches, which all differ, and keeps what the check needs: each
step's loss, the optimizer's first moments after step 1 (the first
gradient as AdamW got it: exp_avg / (1 - beta1)), the parameters after step
3, and the generator's state before each step (the reference redraws the
same t and noise). The same object then runs the window. The numbers read
against the reference (the cell's ``limits`` name those compared):
  * ``loss_gap``: each of the three steps' loss against the reference's,
    relative; the largest.
  * ``grad_gap``: the first gradient's norm, leaf by leaf, against the
    reference's: |norm - reference norm| over the larger of the reference
    leaf's norm and the median leaf's; the worst leaf.
  * ``update_gap``: the same of the parameters' change over the three steps.
  * ``grad_gap_median``, ``update_gap_median``: the median leaf's of each,
    steady from seed to seed.
Leaves whose reference gradient is under a thousandth of the median leaf's
(gradients that are zero but for rounding, as a key projection's bias under
the softmax) are left out of all four by that rule.
"""

from __future__ import annotations

import time

import torch

from portbench import harness, work
from portbench.reference import policy as ref

CHECKED_STEPS = 3
# what ``run.run_cell(side=...)`` may judge besides the program: the reference in
# float8 in the program's place, and the faults planted under the timed path
CONTROLS = ("fp8",)
FAULTS = ("unchanged", "half_batch", "altered")


class Driver:
    unit = "step"

    def __init__(self, cell: dict, conf: dict, seed: int, device, fault: str | None = None):
        self.cell, self.conf, self.cfg = cell, conf, conf["model"]
        self.device = torch.device(device)
        self.fault = fault
        self.w_seed, self.n_seed, self.data_seed, self.step_seed = harness.seeds(seed, 4)

    # ------------------------------------------------------------ set-up

    def make_pool(self) -> list[dict]:
        cfg, c, dev = self.cfg, self.cell, self.device
        g = torch.Generator(device=dev).manual_seed(self.data_seed)
        b, j = c["batch"], cfg["num_joints"]
        two_pi = 2 * torch.pi
        pool = []
        for _ in range(c["pool"]):
            u = lambda *shape: torch.rand(shape, generator=g, device=dev)
            rot = torch.randn((b, cfg["imu_context_length"], work.imu_dim(cfg)), generator=g, device=dev)
            batch = {"joint_command_history": two_pi * u(b, cfg["action_context_length"], j),
                     "joint_state": two_pi * u(b, cfg["joint_state_context_length"], j),
                     "rotation": rot / rot.norm(dim=-1, keepdim=True),
                     "game_state": torch.randint(0, 4, (b,), generator=g, device=dev),
                     "joint_command": two_pi * u(b, cfg["trajectory_prediction_length"], j)}
            if cfg["use_images"]:
                f = cfg["image_context_length"]
                batch["image_u8"] = torch.randint(
                    0, 256, (b, f, work.vit_tokens(cfg), work.vit_patch_dim(cfg)), generator=g,
                    device=dev, dtype=torch.uint8)
                batch["image_valid"] = (u(b, f) >= c["invalid_frames"]).float()
            pool.append(batch)
        return pool

    def setup(self) -> None:
        from soccerdiffusion_tpu_torch.config import ModelConfig
        from soccerdiffusion_tpu_torch.data import Normalizer
        from soccerdiffusion_tpu_torch.diffusion import make_schedule
        from soccerdiffusion_tpu_torch.models import DiffusionPolicy
        from soccerdiffusion_tpu_torch.training.trainer import (
            create_train_state,
            make_optimizer,
            make_train_step,
        )

        c, tc, dev = self.cell, self.conf["train"], self.device
        model = DiffusionPolicy(ModelConfig(**self.cfg)).to(dev)
        self.weights = harness.make_weights(model, self.w_seed, dev)
        g = torch.Generator(device=dev).manual_seed(self.n_seed)
        u = torch.rand((2, self.cfg["num_joints"]), generator=g, device=dev)
        self.norm_mean, self.norm_std = 2.6 + 1.1 * u[0], 0.3 + 0.6 * u[1]
        normalizer = Normalizer(mean=self.norm_mean.clone(), std=self.norm_std.clone())
        self.model = model
        self.optimizer = make_optimizer(model, tc["lr"], c["total_steps"], tc["weight_decay"],
                                        flat=tc["flat_optimizer"], grad_clip_norm=tc["grad_clip_norm"])
        self.step_fn = make_train_step(model, make_schedule(tc["train_denoising_timesteps"]),
                                       self.optimizer, normalizer)
        self.state = create_train_state(model, self.optimizer)
        self.pool = self.make_pool()
        self.gen = torch.Generator(device=dev).manual_seed(self.step_seed)
        self.losses, self.gen_states = [], []
        for i in range(c["warmup_steps"]):
            if i < CHECKED_STEPS:
                self.gen_states.append(self.gen.get_state())
            metrics = self.step(i)
            if i < CHECKED_STEPS:
                self.losses.append(metrics["loss"].detach().clone())
            if i == 0:
                adamw = self.optimizer.adamw
                self.first_grads = {n: adamw.state[p]["exp_avg"].detach().clone() / 0.1
                                    for n, p in model.named_parameters()}
            if i == CHECKED_STEPS - 1:
                self.after = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.count = c["warmup_steps"]

    def unit_flops(self) -> float:
        return work.train_step_flops(self.cfg, self.cell["batch"])

    # ------------------------------------------------------------ the path

    def step(self, i: int) -> dict:
        batch = self.pool[i % len(self.pool)]
        if self.fault == "unchanged":
            keep = [p.detach().clone() for p in self.model.parameters()]
        if self.fault == "half_batch":  # the step's own draws, half the rows left out
            t, noise = self._draw(self.gen)
            h = t.shape[0] // 2
            metrics = self.step_fn.apply(self.state, {k: v[:h] for k, v in batch.items()}, t[:h],
                                         noise[:h])
        else:
            metrics = self.step_fn(self.state, batch, self.gen)
        with torch.no_grad():
            if self.fault == "unchanged":
                for p, k in zip(self.model.parameters(), keep):
                    p.copy_(k)
            elif self.fault == "altered":  # one leaf moved twice as far as the step moved it
                p = self.model.diffusion_action_generator.fc_out.weight
                if hasattr(self, "before_fc"):
                    p.add_(p - self.before_fc)
                self.before_fc = p.detach().clone()
        return metrics

    def window(self, seconds: float) -> dict:
        losses = []
        self.sync()
        t_start = time.perf_counter()
        n = 0
        while time.perf_counter() - t_start < seconds:
            losses.append(self.step(self.count)["loss"])
            self.count += 1
            n += 1
        self.sync()
        elapsed = time.perf_counter() - t_start
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"t_start": t_start, "seconds": elapsed, "units": n, "attempted": n, "failed": failed,
                "metrics": {"train_samples_per_s": self.cell["batch"] * n / elapsed}}

    def traced(self, steps: int) -> None:
        for _ in range(steps):
            self.step(self.count)
            self.count += 1

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        """Free the program: the step, its model and optimizer state, and the
        pool past the checked batches."""
        self.pool = self.pool[:CHECKED_STEPS]
        self.step_fn = self.optimizer = self.state = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _draw(self, g: torch.Generator):
        """A step's t and noise for the whole batch, drawn from ``g`` in
        the step's order (``TrainStep.__call__``)."""
        c, t_max = self.cell, self.conf["train"]["train_denoising_timesteps"]
        shape = (c["batch"], self.cfg["trajectory_prediction_length"], self.cfg["num_joints"])
        t = torch.randint(0, t_max, (c["batch"],), generator=g, device=self.device)
        return t, torch.randn(shape, generator=g, device=self.device)

    def _draws(self) -> list:
        out = []
        for st in self.gen_states:
            g = torch.Generator(device=self.device)
            g.set_state(st)
            out.append(self._draw(g))
        return out

    @staticmethod
    def _norms(tensors: dict) -> dict:
        return {k: float(v.float().norm()) for k, v in tensors.items()}

    def _gaps(self, losses, grads, after, want) -> dict:
        """The three numbers of a run (losses, first gradients, parameters
        after three steps) against the reference's ``want``."""
        w_losses, w_grads, w_after = want
        g_ref = self._norms(w_grads)
        med = sorted(g_ref.values())[len(g_ref) // 2]
        kept = [k for k, v in g_ref.items() if v >= 1e-3 * med]
        d_ref = self._norms({k: w_after[k] - self.weights[k] for k in kept})
        d_med = sorted(d_ref.values())[len(d_ref) // 2]
        g_got = self._norms({k: grads[k] for k in kept})
        d_got = self._norms({k: after[k].float() - self.weights[k] for k in kept})
        gk = {k: abs(g_got[k] - g_ref[k]) / max(g_ref[k], med) for k in kept}
        dk = {k: abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med) for k in kept}
        mid = lambda d: sorted(d.values())[len(d) // 2]
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses)),
                "grad_gap": max(gk.values()), "update_gap": max(dk.values()),
                "grad_gap_median": mid(gk), "update_gap_median": mid(dk),
                "worst_grad_leaf": max(gk, key=gk.get), "worst_update_leaf": max(dk, key=dk.get),
                "left_out": len(g_ref) - len(kept)}

    def check(self, controls: tuple = ()) -> dict:
        ref.exact_float32()
        tc, c = self.conf["train"], self.cell
        draws = self._draws()
        batches = self.pool[:CHECKED_STEPS]
        run = lambda prec: ref.train_steps(self.weights, self.cfg, batches, draws, self.norm_mean,
                                           self.norm_std, tc["lr"], c["total_steps"],
                                           tc["weight_decay"], prec, c["reference_rows"])
        want = run("fp32")
        losses = [float(x) for x in self.losses]
        readings = {"program": self._gaps(losses, self.first_grads, self.after, want)}
        for name in controls:
            readings[name] = self._gaps(*run(name), want)
        return readings
