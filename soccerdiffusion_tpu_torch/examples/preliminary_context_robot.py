"""Tiny-tier example: action-history-conditioned diffusion on ROBOT rows
(counterpart of ``examples/preliminary_context_robot.py``).

The reference's preliminary context-robot pair
(ml/preliminary/train_diffusion_context_transformer_robot.py +
run_diffusion_context_transformer_robot.py, SURVEY.md §2.8): a small
history-only trajectory diffusion model trained on recorded rows from a
dataset DB (the synthetic-wave archetype is ``sine_diffusion_toy``), with
EMA parameter averaging, then rolled out open-loop and plotted against
ground truth. Train and run live in one script, selected by ``--run``.

  python -m soccerdiffusion_tpu_torch.examples.preliminary_context_robot [--db X] [--device cpu]

Without ``--db`` a throwaway DB is synthesized via the dummy-data CLI (the
reference's fetch_data.py step, fetched locally instead); ``--csv`` trains
from ``fetch_data``'s CSV. The plot needs matplotlib (an ImportError naming
it where it is missing, after the open-loop MSE is printed).
"""

from __future__ import annotations

import argparse
import copy
import csv as csv_mod
import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset
from soccerdiffusion_tpu_torch.data.dataset import RecordingArrays
from soccerdiffusion_tpu_torch.diffusion import ddim_sample, make_schedule
from soccerdiffusion_tpu_torch.examples import resolve_device, to_device
from soccerdiffusion_tpu_torch.inference.sampler import eval_mode
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

CFG = ModelConfig(
    # history-only conditioning: every other modality off (the preliminary
    # model conditions on past actions + the step token alone)
    num_joints=20, hidden_dim=64, trajectory_prediction_length=10,
    action_context_length=60, use_imu=False, use_joint_states=False,
    use_images=False, use_gamestate=False,
    num_action_history_encoder_layers=2, num_decoder_layers=2,
)


def csv_dataset(path: str) -> tuple[WindowedDataset, ModelConfig, list[str]]:
    """``fetch_data``'s CSV as a one-recording dataset; the joint count comes
    from the CSV's columns (the reference's leg-only CSVs carry 12 joints,
    not the canonical 20)."""
    with open(path, newline="") as f:
        reader = csv_mod.DictReader(f)
        joints = [c for c in reader.fieldnames if c != "timestamp_ns"]
        rows = np.array([[float(r[j]) for j in joints] for r in reader], dtype=np.float32)
    cfg = dataclasses.replace(CFG, num_joints=len(joints))
    rec = RecordingArrays(
        joint_commands=rows, joint_states=rows.copy(),
        rotations=np.tile(np.array([0, 0, 0, 1], np.float32), (len(rows), 1)),
        game_states=np.zeros((1,), np.int32),
        game_state_stamps=np.zeros((1,), np.float32),
        image_stamps=np.zeros((0,), np.float32), images=None)
    return WindowedDataset([rec], cfg), cfg, joints


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="History-conditioned diffusion on robot rows")
    parser.add_argument("--db", type=str, default=None,
                        help="dataset DB (default: synthesize dummy data)")
    parser.add_argument("--csv", type=str, default=None,
                        help="train from a fetch_data CSV instead of a DB (the reference's "
                             "preliminary input format, ml/preliminary/train_diffusion_context_"
                             "transformer_robot.py:52-60): timestamp_ns + one column per joint")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--run", action="store_true",
                        help="skip training; sample/plot only (loads the params saved by a "
                             "previous train invocation)")
    parser.add_argument("--out", type=str, default="plots/preliminary_context_robot.png")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG
    if args.csv is not None:
        ds, cfg, joints = csv_dataset(args.csv)
        print(f"{len(ds)} windows x {len(joints)} joints from {args.csv}")
    else:
        db = args.db
        if db is None:
            from soccerdiffusion_tpu_torch.cli import main as cli

            db = str(Path(tempfile.mkdtemp()) / "prelim.sqlite3")
            cli(["db", "create-schema", "--db", db])
            cli(["db", "dummy-data", "-n", "2", "-s", "1200", "-i", "50", "--db", db])
        ds = WindowedDataset.from_sqlite(db, cfg)
        print(f"{len(ds)} windows from {db}")
    norm = Normalizer.fit(ds.sample_targets(500))
    model = DiffusionPolicy(cfg)
    model = load_jax_params(model, *flax_init_params(model, 0)).to(device)
    sched = make_schedule(100)
    opt = make_optimizer(model, 1e-3, total_steps=args.steps)
    state = create_train_state(model, opt, ema=True)  # EMA as the reference uses ema_pytorch
    ckpt = Path(tempfile.gettempdir()) / "prelim_context_robot.ckpt"
    if args.run:
        norm = load_checkpoint(ckpt, state)["norm"]
    else:
        step = make_train_step(model, sched, opt, norm, ema_decay=0.99)
        generator = torch.Generator(device=device).manual_seed(0)
        t0, losses, n = time.time(), [], 0
        while n < args.steps:
            for b in ds.batches(32, shuffle=True, seed=n):
                m = step(state, to_device(b, device), generator)
                losses.append(float(m["loss"]))
                n += 1
                if n >= args.steps:
                    break
        print(f"train: {n} steps in {time.time()-t0:.1f}s; "
              f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}")
        if not np.mean(losses[-10:]) < 0.8 * losses[0]:
            print("FAIL: loss did not decrease")
            return 1
        save_checkpoint(ckpt, state, norm, {"preliminary": True}, 0)

    # open-loop: EMA weights (the reference samples the EMA model)
    policy = copy.deepcopy(model)
    policy.load_state_dict({**model.state_dict(), **state.ema})
    idx = np.linspace(0, len(ds) - 1, 4).astype(int)
    items = [ds[int(i)] for i in idx]
    eval_batch = to_device({k: np.stack([it[k] for it in items]) for k in items[0]}, device)
    with torch.no_grad(), eval_mode(policy):
        context = policy.encode_context(eval_batch)

        def denoise_fn(x, t):
            return policy.denoise(context, x, torch.full((4,), t, dtype=torch.int64, device=device))

        noise = torch.randn((4, 10, cfg.num_joints), device=device,
                            generator=torch.Generator(device=device).manual_seed(1))
        traj = norm.to(device).denormalize(ddim_sample(sched, denoise_fn, noise, 30)).cpu().numpy()
    gt = np.stack([it["joint_command"] for it in items])
    mse = float(np.mean((traj - gt) ** 2))
    print(f"open-loop MSE over 4 windows: {mse:.4f} "
          f"(pure-noise floor ~{2 * float(norm.std.mean())**2:.3f})")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    from soccerdiffusion_tpu_torch.data.plot import _require_matplotlib

    plt = _require_matplotlib()
    fig, axes = plt.subplots(2, 2, figsize=(10, 6), sharex=True)
    for ax, tr, g in zip(axes.ravel(), traj, gt):
        for j in range(0, cfg.num_joints, 5):
            ax.plot(g[:, j], "k-", lw=1)
            ax.plot(tr[:, j], "--", lw=1)
    fig.suptitle("preliminary context-robot: sampled (dashed) vs recorded")
    fig.savefig(out, dpi=100)
    plt.close(fig)
    print(f"wrote {out}")
    return 0 if np.isfinite(traj).all() else 1


if __name__ == "__main__":
    raise SystemExit(main())
