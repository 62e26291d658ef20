"""One command: train a teacher, distill few-step students, write the
quality report (counterpart of ``examples/quality_ledger.py``).

A teacher trained on the dummy data with the proprioceptive h128
architecture of the serving benchmark (``BENCH_CONFIG``), students
distilled from it (4-step trajectory-matching and 1-step by default), and
the evaluation report on them: open-loop MSE against the ground truth,
agreement with the teacher, closed-loop divergence, written as JSON and
markdown with the teacher's loss curve folded in. ``--vision`` trains the
camera-conditioned task (``VISION_OVERRIDES``: a ViT camera path on the
"vision" dummy task, whose frames preview the next target) and records the
image-sensitivity probes.

  python -m soccerdiffusion_tpu_torch.evaluation.ledger --out quality_ledger \
      [--vision] [--fast] [--set KEY=VALUE ...] [--device cuda|cpu]

The flags and defaults are the example's, plus ``--device`` (default
``cuda``, which raises where there is no card). The steps run through the
port's ``training/train.py``, ``training/distill.py`` and
``evaluation/report.py`` with the example's arguments and epoch
arithmetic, the dataset resident on the device (``--device-data``).
``RUN_F`` is the round-5 camera recipe (24k teacher steps, a depth-6 ViT,
guided posterior-mean students, the guidance sweep); add ``FUSED`` to its
``--set`` to train it through the fused ViT, encoder-stack and
decoder-layer kernels. ``ledger_faults`` names what a finished camera
ledger must not show.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import tempfile
import time
from pathlib import Path

import torch
import yaml

logger = logging.getLogger("soccerdiffusion_tpu_torch")

# the serving benchmark's headline architecture (proprioceptive default.yaml
# geometry); lr 1e-3, not the reference's 1e-4: on the dummy data a 1e-4
# teacher learns only unconditional denoising in 5000 steps
BENCH_CONFIG = {
    "num_joints": 20,
    "hidden_dim": 128,
    "trajectory_prediction_length": 10,
    "action_context_length": 100,
    "joint_state_context_length": 100,
    "imu_context_length": 100,
    "use_action_history": True,
    "num_action_history_encoder_layers": 2,
    "use_imu": True,
    "num_imu_encoder_layers": 2,
    "use_joint_states": True,
    "joint_state_encoder_layers": 2,
    "use_images": False,
    "use_gamestate": True,
    "num_decoder_layers": 4,
    "encoder_patch_size": 1,
    "train_denoising_timesteps": 1000,
    "distill_teacher_inference_steps": 30,
    "batch_size": 64,
    "lr": 1.0e-3,
    "epochs": 10,
}

# --vision: the same skeleton plus a small ViT camera path, trained on the
# "vision" dummy task (each image previews the next target interval, so the
# future chunk is unpredictable from the proprioceptive history alone)
VISION_OVERRIDES = {
    "dummy_task": "vision",
    "use_images": True,
    "image_encoder_type": "vit",
    "image_sequence_encoder_type": "transformer",
    "num_image_sequence_encoder_layers": 1,
    "image_context_length": 5,
    "image_resolution": 96,
    "vit_patch_size": 16,
    "vit_width": 128,
    "vit_depth": 4,
}

# --fast: a seconds-scale smoke configuration
FAST_OVERRIDES = {
    "hidden_dim": 32, "action_context_length": 20, "imu_context_length": 20,
    "joint_state_context_length": 20, "num_action_history_encoder_layers": 1,
    "num_imu_encoder_layers": 1, "joint_state_encoder_layers": 1, "num_decoder_layers": 1,
    "train_denoising_timesteps": 50, "distill_teacher_inference_steps": 5, "batch_size": 16,
}
FAST_VISION_OVERRIDES = {"image_resolution": 32, "vit_patch_size": 8, "vit_width": 32,
                         "vit_depth": 1, "image_context_length": 2}

# the round-5 camera recipe ("run F": docs/ROUND4.md's levers, docs/ROUND5.md's
# scale), in bf16; its students distil the w=7 guided, 8-draw teacher
RUN_F = ["--vision", "--train-steps", "24000", "--distill-steps", "1200",
         "--set", "vit_depth=6", "--set", "boundary_oversample=0.5",
         "--set", "image_encoder_lr_mult=3", "--set", "aux_cue_head=true",
         "--set", "aux_cue_weight=1", "--set", "grad_clip_norm=1",
         "--set", "modality_dropout=0.15", "--set", "compute_dtype=bfloat16",
         "--student-steps", "4", "1", "--student-guidance", "7.0@image",
         "--student-teacher-draws", "8",
         "--guidance-rows", "5.0@image", "7.0@image", "9.0@image", "--posterior-mean", "8"]
# the training kernels: the ViT blocks, the encoder stacks, the decoder layers
FUSED = ["--set", "vit_fused_block=true", "--set", "encoder_fused_stack=true",
         "--set", "decoder_fused_block=true"]

# a camera ledger's teacher must land under this share of the pure-noise
# floor and reach this posterior-mean boundary ratio under cfg5 (round 4's
# done criterion)
MSE_FLOOR_SHARE, MIN_CFG5_RATIO = 0.1, 2.0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="End-to-end quality ledger (PyTorch port)")
    parser.add_argument("--out", type=str, default="quality_ledger")
    parser.add_argument("--workdir", type=str, default=None,
                        help="where checkpoints land (default: temp dir)")
    parser.add_argument("--train-steps", type=int, default=2000)
    parser.add_argument("--distill-steps", type=int, default=400)
    parser.add_argument("--student-steps", type=int, nargs="*", default=[4, 1])
    parser.add_argument("--solver-rows", type=str, nargs="*", default=None,
                        help="training-free sampler rows on the teacher, e.g. dpmpp10@lambda "
                             "or ddim10; default dpmpp10@lambda+ddim10, none for --vision")
    parser.add_argument("--guidance-rows", type=str, nargs="*", default=[],
                        help="classifier-free-guidance rows on the teacher, "
                             "SCALE[@MODALITY,...] e.g. 2.0@image (pair with --set "
                             "modality_dropout=0.15)")
    parser.add_argument("--posterior-mean", type=int, default=0,
                        help="K>1: posterior-mean boundary rows for the teacher and every "
                             "student, each with its NFE a replan")
    parser.add_argument("--student-guidance", type=str, default=None,
                        help="distill the students from a CFG-guided teacher, "
                             "SCALE[@MODALITY,...] (training/distill.py --guidance)")
    parser.add_argument("--student-teacher-draws", type=int, default=1,
                        help="K>1: distill the students from the posterior-mean teacher "
                             "(training/distill.py --teacher-draws)")
    parser.add_argument("--windows", type=int, default=256)
    parser.add_argument("--chunks", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fast", action="store_true",
                        help="seconds-scale smoke: tiny model + few steps")
    parser.add_argument("--vision", action="store_true",
                        help="camera-conditioned run: the 'vision' dummy task with a small ViT "
                             "camera path and the image-shuffle sensitivity probes")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        dest="overrides",
                        help="override a training-config key (YAML-parsed value), e.g. "
                             "--set ema_decay=0.999")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.solver_rows is None:
        args.solver_rows = [] if args.vision else ["dpmpp10@lambda", "ddim10"]
    for kv in args.overrides:
        if "=" not in kv:
            parser.error(f"--set expects KEY=VALUE, got {kv!r}")
    return args


def ledger_config(args: argparse.Namespace) -> dict:
    """The training config of ``args`` (``parse_args``); with ``--fast`` it
    also cuts ``args``' steps, windows and chunks, as the example does."""
    config = dict(BENCH_CONFIG)
    if args.vision:
        config.update(VISION_OVERRIDES)
    if args.fast:
        config.update(FAST_OVERRIDES)
        if args.vision:
            config.update(FAST_VISION_OVERRIDES)
        args.train_steps = min(args.train_steps, 30)
        args.distill_steps = min(args.distill_steps, 10)
        args.windows = min(args.windows, 16)
        args.chunks = min(args.chunks, 3)
    for kv in args.overrides:  # --set wins over every built-in block, --fast's included
        key, _, value = kv.partition("=")
        config[key] = yaml.safe_load(value)
    return config


def steps_per_epoch(config: dict, seed: int) -> int:
    """The optimizer steps of one epoch over the dummy dataset."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    return max(1, len(build_dataset(Config.from_dict(config), seed, True)) // config["batch_size"])


def ledger_faults(result: dict) -> list[str]:
    """What a camera ledger (a ``--vision`` run with a 5.0@image guidance
    row and posterior-mean rows) must not show: a value that is not finite,
    a teacher open-loop MSE at or above ``MSE_FLOOR_SHARE`` of the
    pure-noise floor, a teacher cfg5 posterior-mean boundary ratio under
    ``MIN_CFG5_RATIO``. Empty when it shows none."""
    faults = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, float) and not math.isfinite(node):
            faults.append(f"{path} is {node}")

    walk(result, "ledger")
    mse, floor = result["checkpoints"][0]["open_loop"]["mse"], result["noise_floor_mse"]
    if not mse < MSE_FLOOR_SHARE * floor:
        faults.append(f"teacher open-loop MSE {mse:.5f} is not under {MSE_FLOOR_SHARE:g} of the "
                      f"noise floor {floor:.5f}")
    rows = result.get("posterior_mean_boundary", {}).get("rows", [])
    cfg5 = [r for r in rows if r["name"] == "teacher" and r["scale"] == 5.0]
    if not cfg5:
        faults.append("no teacher cfg5 posterior-mean boundary row")
    elif not cfg5[0]["ratio_shuffled_over_true"] >= MIN_CFG5_RATIO:
        faults.append(f"teacher cfg5 posterior-mean boundary ratio "
                      f"{cfg5[0]['ratio_shuffled_over_true']:.3f} is under {MIN_CFG5_RATIO:g}x")
    return faults


def distill_students(args: argparse.Namespace, cfg_path: Path, teacher: Path,
                     per_epoch: int) -> dict[str, float]:
    """Distill a student of each of ``args.student_steps`` steps from
    ``teacher`` (``args.student_guidance`` and ``args.student_teacher_draws``:
    ``training/distill.py``'s ``--guidance`` and ``--teacher-draws``) into
    ``student{k}.ckpt`` beside the config; returns each one's host seconds
    by path."""
    from soccerdiffusion_tpu_torch.training import distill as distill_mod

    seconds = {}
    for k in args.student_steps:
        out = cfg_path.parent / f"student{k}.ckpt"
        d_epochs = max(1, -(-args.distill_steps // per_epoch))
        logger.info(f"[ledger] distilling {k}-step student: {args.distill_steps} steps")
        distill_argv = [
            str(cfg_path), str(teacher), "--student-steps", str(k),
            "--dummy-data", "--epochs", str(d_epochs), "--steps-per-epoch", str(per_epoch),
            "-o", str(out), "--seed", str(args.seed),
            "--metrics", str(cfg_path.parent / f"student{k}_metrics.jsonl"),
            "--device-data", "--device", args.device,
        ]
        if args.student_guidance:
            distill_argv += ["--guidance", args.student_guidance]
        if args.student_teacher_draws > 1:
            distill_argv += ["--teacher-draws", str(args.student_teacher_draws)]
        t0 = time.perf_counter()
        distill_mod.main(distill_argv)
        seconds[str(out)] = time.perf_counter() - t0
    return seconds


def report_argv(args: argparse.Namespace, config: dict, teacher: Path, students,
                out: str) -> list[str]:
    """``evaluation/report.py``'s arguments for the ledger's report on
    ``teacher`` and ``students``, written to ``out``."""
    argv = ["--teacher", str(teacher), "--dummy-data",
            "--windows", str(args.windows), "--chunks", str(args.chunks),
            "--batch-size", str(min(64, config["batch_size"])), "--seed", str(args.seed),
            "--out", out, "--device", args.device]
    for s in students:
        argv += ["--student", str(s)]
    for row in args.solver_rows:
        argv += ["--solver-row", row]
    for row in args.guidance_rows:
        argv += ["--guidance-row", row]
    if args.posterior_mean > 1:
        argv += ["--posterior-mean", str(args.posterior_mean)]
    return argv


def main(argv=None) -> dict:
    """The ledger's report (with ``teacher_loss_curve``, ``train_steps``,
    ``distill_steps`` and the host seconds of each stage, ``wall_s``)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={args.device!r} requested but CUDA is not available")
    config = ledger_config(args)

    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="ledger_"))
    workdir.mkdir(parents=True, exist_ok=True)
    cfg_path = workdir / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))

    from soccerdiffusion_tpu_torch.evaluation import report as report_mod
    from soccerdiffusion_tpu_torch.training import train as train_mod

    # the dummy dataset yields ~1k windows: spread the requested optimizer
    # steps over epochs
    per_epoch = steps_per_epoch(config, args.seed)
    epochs = max(1, -(-args.train_steps // per_epoch))

    teacher = workdir / "teacher.ckpt"
    logger.info(f"[ledger] training teacher: {args.train_steps} steps "
                f"({epochs} epochs x {per_epoch})")
    t0 = time.perf_counter()
    # one process: the small dummy dataset stays resident on the device
    train_mod.main([
        "--config", str(cfg_path), "--dummy-data", "--epochs", str(epochs),
        "--output", str(teacher), "--seed", str(args.seed),
        "--metrics", str(workdir / "teacher_metrics.jsonl"),
        "--device-data", "--device", args.device,
    ])
    wall = {"teacher": time.perf_counter() - t0}

    students = distill_students(args, cfg_path, teacher, per_epoch)
    wall.update((Path(s).stem, sec) for s, sec in students.items())
    t0 = time.perf_counter()
    result = report_mod.main(report_argv(args, config, teacher, students, args.out))
    wall["report"] = time.perf_counter() - t0

    # fold the teacher's learning curve into the ledger
    curve_path = workdir / "teacher_metrics.jsonl"
    records = [json.loads(line) for line in curve_path.read_text().splitlines()]
    losses = [(r["step"], r["loss"]) for r in records if "loss" in r]
    out = Path(args.out)
    result.update(teacher_loss_curve=losses, train_steps=args.train_steps,
                  distill_steps=args.distill_steps, wall_s=wall)
    out.with_suffix(".json").write_text(json.dumps(result, indent=2))
    if losses:
        first, last = losses[0][1], losses[-1][1]
        md = out.with_suffix(".md")
        md.write_text(md.read_text() + (
            f"\nTeacher training loss: {first:.4f} (step {losses[0][0]}) "
            f"-> {last:.4f} (step {losses[-1][0]}), {len(losses)} recorded points.\n"))
    logger.info(f"[ledger] checkpoints in {workdir}; report at {args.out}.md")
    return result


if __name__ == "__main__":
    main()
