"""End-to-end smoke: dummy data -> train -> DDIM sample -> distill -> rollout
(counterpart of ``examples/e2e_smoke.py``).

The framework's MVP slice (SURVEY.md §7 step 3) as one runnable script:

  python -m soccerdiffusion_tpu_torch.examples.e2e_smoke [--device cpu]

Exits non-zero if the loss fails to drop or any stage produces non-finite
output. The tiny config (hidden 32, 4 heads) sets no fused knob and the
engine serves unfused, as the JAX script runs without its Pallas kernels:
the plain path on the card too.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.examples import resolve_device, to_device
from soccerdiffusion_tpu_torch.inference import RolloutEngine, make_chunk_sampler
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.distill import make_distill_step
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Train, sample, distill and roll out a tiny policy")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        num_joints=8, hidden_dim=32, trajectory_prediction_length=10,
        action_context_length=40, joint_state_context_length=40, imu_context_length=40,
        use_images=False, num_action_history_encoder_layers=1,
        num_imu_encoder_layers=1, joint_state_encoder_layers=1, num_decoder_layers=2,
    )
    dummy = generate_dummy_arrays(1, 500, num_joints=cfg.num_joints)
    ds = WindowedDataset.from_dummy(dummy, cfg)
    norm = Normalizer.fit(ds.sample_targets(300))
    model = DiffusionPolicy(cfg)
    model = load_jax_params(model, *flax_init_params(model, 0)).to(device)
    sched = make_schedule(100)
    opt = make_optimizer(model, 1e-3, total_steps=120)

    batch = to_device(next(ds.batches(32, shuffle=False)), device)
    state = create_train_state(model, opt)
    step = make_train_step(model, sched, opt, norm)
    generator = torch.Generator(device=device).manual_seed(0)

    t0 = time.time()
    losses = []
    for epoch in range(4):
        for b in ds.batches(32, shuffle=True, seed=epoch):
            m = step(state, to_device(b, device), generator)
            losses.append(float(m["loss"]))
    print(f"train: {len(losses)} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}")
    if not np.mean(losses[-5:]) < 0.8 * losses[0]:
        print("FAIL: loss did not decrease")
        return 1

    sampler = make_chunk_sampler(model, sched, norm, num_inference_steps=30)
    noise = torch.randn((32, cfg.trajectory_prediction_length, cfg.num_joints), device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    chunk = sampler(batch, noise)
    finite = bool(torch.isfinite(chunk).all())
    print(f"30-step DDIM chunk: {tuple(chunk.shape)}, finite={finite}")
    if not finite:
        return 1

    # distill a few steps
    dstep = make_distill_step(model, sched, opt, teacher_inference_steps=10)
    teacher = copy.deepcopy(model)
    dlosses = []
    for epoch in range(2):
        for b in ds.batches(32, shuffle=True, seed=10 + epoch):
            m = dstep(state, teacher, to_device(b, device), generator)
            dlosses.append(float(m["loss"]))
    print(f"distill: loss {dlosses[0]:.4f} -> {dlosses[-1]:.4f}")
    if not dlosses[-1] < dlosses[0]:
        print("FAIL: distill loss did not decrease")
        return 1

    engine = RolloutEngine(model, sched, norm, num_inference_steps=5, distilled=True,
                           device=device)
    carry = engine.init(batch_size=16, generator=torch.Generator(device=device).manual_seed(2))
    carry, chunks = engine.make_rollout_fn(num_chunks=3)(carry)
    finite = bool(torch.isfinite(chunks).all())
    print(f"rollout: {tuple(chunks.shape)}, finite={finite}")
    if not finite:
        return 1

    print("E2E SMOKE PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
