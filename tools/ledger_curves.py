"""The camera ledger's two training variants on one card: run F's recipe
(``evaluation/ledger.py``: ``RUN_F``, bf16) with plain torch layers (a) and
through the fused ViT-block, encoder-stack and decoder-layer kernels (b,
``RUN_F + FUSED``), each for the first ``--steps`` steps of its 24k-step
schedule from the same seed: the same data order, noise and dropout masks,
so the two loss curves should track each other step by step early on.
Prints and writes both curves (every ``log_every`` steps), their largest
gap and each variant's ms per step (host clock, the logging windows after
the first); with ``--distill-steps N`` also times N steps of each of the
recipe's student distillations (4 and 1 steps, the guided 8-draw teacher)
from variant (b)'s teacher.

    python tools/ledger_curves.py [--steps 2000] [--distill-steps 6]
        [--variants b,a] [--out build/ledger_curves.json]

Needs an NVIDIA GPU; builds the kernels like chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import yaml

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from soccerdiffusion_tpu_torch.config import Config  # noqa: E402
from soccerdiffusion_tpu_torch.evaluation import ledger  # noqa: E402
from soccerdiffusion_tpu_torch.ops import _build  # noqa: E402
from soccerdiffusion_tpu_torch.training import distill  # noqa: E402
from soccerdiffusion_tpu_torch.training.train import RunOptions, train  # noqa: E402

VARIANTS = {"a": [], "b": ledger.FUSED}


def records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def window_ms(recs: list[dict]) -> float:
    """The median ms per step of the logging windows after the first."""
    return statistics.median(1e3 / r["steps_per_sec"] for r in recs[1:])


def curve(variant: str, steps: int, work: Path) -> tuple[dict, Path, dict]:
    """Variant ``variant``'s first ``steps`` steps: (its curve and times, its
    config's YAML, the parsed ledger arguments)."""
    args = ledger.parse_args(ledger.RUN_F + VARIANTS[variant])
    cfg = ledger.ledger_config(args)
    yml = work / f"{variant}.yaml"
    yml.write_text(yaml.safe_dump(cfg))
    per_epoch = ledger.steps_per_epoch(cfg, args.seed)
    epochs = -(-args.train_steps // per_epoch)
    metrics = work / f"{variant}.jsonl"
    t0 = time.perf_counter()
    train(Config.from_dict(cfg), RunOptions(
        output=str(work / f"{variant}.ckpt"), epochs=epochs, seed=args.seed,
        metrics=str(metrics), device="cuda", device_data=True, max_steps=steps),
        hyperparams=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recs = records(metrics)
    out = {"step": [r["step"] for r in recs], "loss": [r["loss"] for r in recs],
           "aux_cue_loss": [r.get("aux_cue_loss") for r in recs],
           "grad_norm": [r["grad_norm"] for r in recs], "ms_per_step": window_ms(recs),
           "wall_s": wall, "epochs_of_schedule": epochs, "steps_per_epoch": per_epoch}
    print(f"variant ({variant}): {steps} steps in {wall:.1f} s, {out['ms_per_step']:.3f} ms/step "
          f"(median of the logging windows after the first)", flush=True)
    return out, yml, args


def distill_times(yml: Path, teacher: Path, args, n: int, work: Path) -> dict:
    """ms per step of each of the recipe's distillations: two epochs of n
    steps, timed over the second (the log record at its last step)."""
    out = {}
    for k in args.student_steps:
        metrics = work / f"distill{k}.jsonl"
        t0 = time.perf_counter()
        distill.main([str(yml), str(teacher), "--student-steps", str(k),
                      "--guidance", args.student_guidance,
                      "--teacher-draws", str(args.student_teacher_draws), "--dummy-data",
                      "--epochs", "2", "--steps-per-epoch", str(n),
                      "-o", str(work / f"student{k}.ckpt"), "--metrics", str(metrics),
                      "--device-data", "--device", "cuda"])
        wall = time.perf_counter() - t0
        ms = 1e3 * records(metrics)[-1]["wall_dt"] / n
        out[f"student{k}"] = {"ms_per_step": ms, "wall_s": wall}
        print(f"distillation of a {k}-step student ({args.student_guidance}, "
              f"{args.student_teacher_draws} draws): {ms:.1f} ms/step ({2 * n} steps, "
              f"{wall:.1f} s with set-up)", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--distill-steps", type=int, default=0)
    parser.add_argument("--variants", default="b,a")
    parser.add_argument("--out", default="build/ledger_curves.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ledger_curves: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.library()
    result = {"gpu": smi, "steps": args.steps, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for v in args.variants.split(","):
            result["variants"][v], yml, largs = curve(v, args.steps, work)
            if v == "b" and args.distill_steps:
                result["distill"] = distill_times(yml, work / "b.ckpt", largs,
                                                  args.distill_steps, work)
    runs = result["variants"]
    if {"a", "b"} <= set(runs):
        a, b = runs["a"], runs["b"]
        gaps = [abs(x - y) / abs(x) for x, y in zip(a["loss"], b["loss"])]
        result["max_rel_loss_gap"] = max(gaps)
        print("step  loss (a)  loss (b)  |b - a| / a")
        for s, x, y, g in zip(a["step"], a["loss"], b["loss"], gaps):
            if (s + 1) % 200 == 0 or s < 100:
                print(f"{s:5d}  {x:.5f}  {y:.5f}  {g:.4f}")
        print(f"largest relative gap over {len(gaps)} records: {max(gaps):.4f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "variants"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
