"""Tiny-tier example: unconditional-ish diffusion on synthetic sine waves
(counterpart of ``examples/sine_diffusion_toy.py``).

The reference's preliminary research scripts
(ml/preliminary/train_diffusion_transformer.py and friends, SURVEY.md
§2.8) and BASELINE.json config[0]: a small transformer denoiser learns to
generate sine-wave "joint trajectories" conditioned only on the action
history, trained and sampled in under a minute.

  python -m soccerdiffusion_tpu_torch.examples.sine_diffusion_toy [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import ddim_sample, make_schedule
from soccerdiffusion_tpu_torch.examples import resolve_device, to_device
from soccerdiffusion_tpu_torch.inference.sampler import eval_mode
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

HIST, PRED, JOINTS = 40, 10, 4
TRAIN_STEPS = 800


def sine_batch(rng: np.random.Generator, batch: int) -> dict[str, np.ndarray]:
    """History + future windows of multi-frequency sine waves."""
    freqs = rng.uniform(0.5, 2.0, (batch, JOINTS))
    phases = rng.uniform(0, 2 * np.pi, (batch, JOINTS))
    t = np.arange(HIST + PRED) * 0.05
    waves = np.sin(freqs[:, None, :] * t[None, :, None] + phases[:, None, :])
    waves = waves.astype(np.float32) + np.pi  # [0, 2pi)-style domain
    return {"joint_command_history": waves[:, :HIST], "joint_command": waves[:, HIST:]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Diffusion on synthetic sine waves")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        num_joints=JOINTS, hidden_dim=64, trajectory_prediction_length=PRED,
        action_context_length=HIST, use_imu=False, use_joint_states=False,
        use_images=False, use_gamestate=False,
        num_action_history_encoder_layers=1, num_decoder_layers=2,
        encoder_patch_size=1,
    )
    model = DiffusionPolicy(cfg)
    model = load_jax_params(model, *flax_init_params(model, 0)).to(device)
    sched = make_schedule(100)
    opt = make_optimizer(model, 3e-3, total_steps=TRAIN_STEPS)
    norm = Normalizer(mean=torch.full((JOINTS,), np.pi), std=torch.full((JOINTS,), 0.71))

    rng = np.random.default_rng(0)
    state = create_train_state(model, opt)
    step = make_train_step(model, sched, opt, norm)
    generator = torch.Generator(device=device).manual_seed(0)

    t0 = time.time()
    losses = []
    for i in range(TRAIN_STEPS):
        m = step(state, to_device(sine_batch(rng, 64), device), generator)
        losses.append(float(m["loss"]))
        if i % 200 == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    print(f"trained {TRAIN_STEPS} steps in {time.time()-t0:.1f}s; "
          f"final loss {np.mean(losses[-10:]):.4f}")

    # Sample continuations and measure fit against the true future.
    test = to_device(sine_batch(rng, 16), device)
    with torch.no_grad(), eval_mode(model):
        ctx = model.encode_context(test)

        def denoise_fn(x, t):
            return model.denoise(ctx, x, torch.full((16,), t, dtype=torch.int64, device=device))

        noise = torch.randn((16, PRED, JOINTS), device=device,
                            generator=torch.Generator(device=device).manual_seed(3))
        sampled = norm.to(device).denormalize(ddim_sample(sched, denoise_fn, noise, 30))
    err = float((sampled - test["joint_command"]).abs().mean())
    print(f"mean |sampled - true future| = {err:.3f} (vs ~0.8 for pure noise)")
    ok = np.mean(losses[-10:]) < 0.4 and err < 0.55
    print("SINE TOY PASSED" if ok else "SINE TOY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
