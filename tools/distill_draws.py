"""A K-draw distillation step (``training/distill.py``) with its teacher
draws rolled out as one batch of K x B rows, as the port does, against the
same step with the draws rolled out one after another, as the JAX
distiller maps over them: per configuration the step's ms (the median of 3
after 1, host clock between device syncs) and the device's peak memory
during one step, both ways in one process, from the same teacher, batch
and noise, with the two losses side by side.

The cases: the camera ledger's run F teacher (``evaluation/ledger.py``:
``RUN_F + FUSED``, B=64) guided 7.0@image with 8 draws; every shipped YAML
at its own batch with 8 draws, guided 7.0@image where it has a camera;
and phase 12's ``student1_draws2`` (``larger_model_distill.yaml``, B=32,
2 unguided draws). Teachers are seeded random initialisations: neither the
time nor the memory of a step depends on the weights. The one-after-another
form encodes the teacher's context once a draw, where the JAX distiller
encodes it once a step.

    python tools/distill_draws.py [--cases ledger,vit_flagship.yaml,...]
        [--out build/distill_draws.json]

Needs an NVIDIA GPU; builds the kernels like chip_smoke.py.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from soccerdiffusion_tpu_torch.config import Config  # noqa: E402
from soccerdiffusion_tpu_torch.data.pipeline import parse_guidance_spec, to_tensors  # noqa: E402
from soccerdiffusion_tpu_torch.diffusion import make_schedule  # noqa: E402
from soccerdiffusion_tpu_torch.evaluation import ledger  # noqa: E402
from soccerdiffusion_tpu_torch.models import DiffusionPolicy  # noqa: E402
from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, DistillStep  # noqa: E402
from soccerdiffusion_tpu_torch.training.train import build_dataset  # noqa: E402
from soccerdiffusion_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state,
    make_optimizer,
)

CONFIG_DIR = REPO / "soccerdiffusion_tpu_torch" / "training" / "configs"
K, GUIDANCE = 8, "7.0@image"


class InTurn(DistillStep):
    """The same step with the K draws rolled out one after another, summed
    in draw order."""

    def teacher_trajectory(self, teacher, batch, noise, draw_noise):
        if draw_noise is None:
            return super().teacher_trajectory(teacher, batch, noise, None)
        total = None
        for n in draw_noise:
            context, traj = super().teacher_trajectory(teacher, batch, noise, n[None])
            total = traj if total is None else total + traj
        return context, total / len(draw_noise)


def cases() -> dict[str, tuple[Config, int, int, int, str | None]]:
    """name -> (config, batch, student steps, draws, guidance spec)."""
    out = {"ledger": (Config.from_dict(ledger.ledger_config(ledger.parse_args(
        ledger.RUN_F + ledger.FUSED))), 64, 4, K, GUIDANCE)}
    for path in sorted(CONFIG_DIR.glob("*.yaml")):
        cfg = Config.from_yaml(str(path))
        out[path.name] = (cfg, cfg.train.batch_size, 4, K,
                          GUIDANCE if cfg.model.use_images else None)
    distill_yaml = Config.from_yaml(str(CONFIG_DIR / "larger_model_distill.yaml"))
    out["phase12_student1_draws2"] = (distill_yaml, 32, 1, 2, None)
    return out


def measure(cfg: Config, b: int, student_steps: int, draws: int, guidance: str | None,
            device: str) -> dict:
    """Both forms' step ms, peak bytes and first loss on one teacher and batch."""
    torch.manual_seed(0)
    teacher = DiffusionPolicy(cfg.model).to(device).eval().requires_grad_(False)
    dataset = build_dataset(cfg, 0, True, packed=True)
    batch = {k: v.to(device) for k, v in to_tensors(next(dataset.batches(b, seed=0))).items()}
    scale, null = parse_guidance_spec(guidance) if guidance else (1.0, ())
    gen = torch.Generator(device).manual_seed(1)
    shape = (b, cfg.model.trajectory_prediction_length, cfg.model.num_joints)
    inputs = [(torch.randn(shape, generator=gen, device=device),
               torch.randn((draws, *shape), generator=gen, device=device)) for _ in range(4)]
    out = {"batch": b, "student_steps": student_steps, "draws": draws, "guidance": guidance}
    for form, cls in (("batched", DistillStep), ("in_turn", InTurn)):
        student = copy.deepcopy(teacher).requires_grad_(True)
        opt = make_optimizer(student, 1e-3, 10, trainable=TRAINABLE)
        state = create_train_state(student, opt)
        step = cls(student, make_schedule(cfg.train.train_denoising_timesteps), opt,
                   cfg.train.distill_teacher_inference_steps, student_steps, scale, null, draws)
        try:
            times, losses = [], []
            for i, (noise, draw_noise) in enumerate(inputs):
                torch.cuda.synchronize()
                if i == 1:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                losses.append(step.apply(state, teacher, batch, noise, draw_noise)["loss"].item())
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 1:
                    peak = torch.cuda.max_memory_allocated()
            out[form] = {"ms": statistics.median(times[1:]), "steps_ms": times,
                         "peak_bytes": peak, "peak_over_start_bytes": peak - base,
                         "first_loss": losses[0]}
        except torch.cuda.OutOfMemoryError as exc:
            out[form] = {"out_of_memory": str(exc).splitlines()[0]}
        del student, opt, state, step
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cases", default=None, help="comma-separated case names (default all)")
    parser.add_argument("--out", default="build/distill_draws.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("distill_draws: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from soccerdiffusion_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.library()
    table = cases()
    names = args.cases.split(",") if args.cases else list(table)
    result = {"gpu": smi, "cases": {}}
    for name in names:
        r = measure(*table[name], device="cuda")
        result["cases"][name] = r
        line = ", ".join(
            f"{form} " + (v["out_of_memory"] if "out_of_memory" in v else
                          f"{v['ms']:.1f} ms, peak {v['peak_bytes'] / 2**30:.2f} GiB (+"
                          f"{v['peak_over_start_bytes'] / 2**30:.2f}), loss {v['first_loss']:.6g}")
            for form, v in r.items() if isinstance(v, dict))
        print(f"{name} B={r['batch']} K={r['draws']} student{r['student_steps']} "
              f"{r['guidance'] or 'unguided'}: {line}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
