"""Offline open-loop plots (counterpart of
``soccerdiffusion_tpu/inference/plot.py``).

Load a checkpoint (its hyperparameters ride inside), sample dataset
windows, run the checkpoint's sampler (the iterative one, or the distilled
student's single forward) and plot per joint the action-history context,
the initial noise, the denoised prediction and the ground-truth target.

  python -m soccerdiffusion_tpu_torch.inference.plot <ckpt_dir> [--steps 30]
      [--num-samples 5] [--dummy-data] [--db path] [-o out_dir] [--device cuda|cpu]

matplotlib is imported only when the plots are drawn.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data.pipeline import null_modalities
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.evaluation.openloop import sample_trajectories
from soccerdiffusion_tpu_torch.inference.sampler import eval_mode
from soccerdiffusion_tpu_torch.training.checkpoint import load_policy

logger = logging.getLogger("soccerdiffusion_tpu_torch")


@torch.no_grad()
def sample_open_loop(model, normalizer, schedule, batch: dict, steps: int, distilled: bool,
                     noise: torch.Tensor, guidance_scale: float = 1.0,
                     guidance_null: tuple[str, ...] = ("image",)):
    """``(denoised, initial noise)`` in the denormalised joint domain, from
    ``noise`` (B, P, J); ``batch`` on the model's device. ``guidance_scale``
    != 1 plots classifier-free-guided samples (iterative samplers only)."""
    normalizer = normalizer.to(noise.device)
    with eval_mode(model):
        context = model.encode_context(batch)
        uncond = None
        if guidance_scale != 1.0 and not distilled:
            uncond = model.encode_context(null_modalities(batch, guidance_null))
        traj = sample_trajectories(model, schedule, context, noise, steps, distilled,
                                   uncond_context=uncond, guidance_scale=guidance_scale)
    return normalizer.denormalize(traj), normalizer.denormalize(noise)


def main(argv=None):
    from soccerdiffusion_tpu_torch.data.pipeline import parse_guidance_spec
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    parser = argparse.ArgumentParser(description="Plot open-loop samples (PyTorch port)")
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("--steps", type=int, default=None,
                        help="sampler steps (default: the checkpoint's own operating point, "
                             "training/checkpoint.py:load_policy)")
    parser.add_argument("--num-samples", type=int, default=5)
    parser.add_argument("--dummy-data", action="store_true")
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--output", "-o", type=str, default="plots")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--guidance", type=str, default=None, metavar="SCALE[@MODALITY,...]",
                        help="classifier-free guidance, e.g. '2.0@image' (iterative samplers "
                             "only; meaningful on modality_dropout-trained checkpoints)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    g_scale, g_null = 1.0, ("image",)
    if args.guidance:
        try:
            g_scale, g_null = parse_guidance_spec(args.guidance)
        except ValueError as e:
            parser.error(str(e))
    device = torch.device(args.device)
    # the step count plotted is the one served and evaluated
    model, normalizer, ckpt_steps, distilled, params = load_policy(args.checkpoint, device)
    if g_scale != 1.0 and distilled:
        parser.error("--guidance requires an iterative sampler; "
                     f"{args.checkpoint} is a distilled checkpoint whose single forward is not "
                     "a score prediction")
    config = Config.from_dict(params)
    steps = ckpt_steps if args.steps is None else args.steps
    schedule = make_schedule(config.train.train_denoising_timesteps)
    dataset = build_dataset(config, args.seed, args.dummy_data, db=args.db)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    from soccerdiffusion_tpu_torch.data.plot import _require_matplotlib

    plt = _require_matplotlib()
    rng = np.random.default_rng(args.seed)
    cfg = config.model
    pred_len = cfg.trajectory_prediction_length
    for s in range(args.num_samples):
        idx = int(rng.integers(len(dataset)))
        item = dataset[idx]
        batch = {k: torch.from_numpy(np.asarray(v)[None]).to(device)
                 for k, v in item.items()}
        generator = torch.Generator(device=device).manual_seed(args.seed + s)
        noise = torch.randn((1, pred_len, cfg.num_joints), generator=generator, device=device)
        traj, noisy = sample_open_loop(model, normalizer, schedule, batch, steps, distilled, noise,
                                       guidance_scale=g_scale, guidance_null=g_null)
        traj, noisy = traj[0].cpu().numpy(), noisy[0].cpu().numpy()
        target = item["joint_command"]
        history = item.get("joint_command_history")

        n = cfg.num_joints
        ncols = 4
        nrows = -(-n // ncols)
        fig, axes = plt.subplots(nrows, ncols, figsize=(16, 3 * nrows), squeeze=False)
        hist_len = len(history) if history is not None else 0
        t_hist = np.arange(-hist_len, 0)
        t_pred = np.arange(pred_len)
        for j in range(n):
            ax = axes[j // ncols][j % ncols]
            if history is not None:
                ax.plot(t_hist, history[:, j], label="context", color="gray")
            ax.plot(t_pred, noisy[:, j], label="noisy", color="orange", alpha=0.5)
            ax.plot(t_pred, traj[:, j], label="denoised", color="tab:blue")
            ax.plot(t_pred, target[:, j], label="target", color="tab:green")
            ax.set_title(cfg.joint_names[j], fontsize=8)
        axes[0][0].legend(fontsize=6)
        fig.tight_layout()
        path = out_dir / f"sample_{s}.png"
        fig.savefig(path, dpi=100)
        plt.close(fig)
        logger.info(f"wrote {path}")


if __name__ == "__main__":
    main()
