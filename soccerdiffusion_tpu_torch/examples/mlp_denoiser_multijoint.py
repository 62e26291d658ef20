"""Tiny-tier example: unconditional MLP denoiser over whole leg trajectories
(counterpart of ``examples/mlp_denoiser_multijoint.py``).

The reference's preliminary MLP archetype
(ml/preliminary/train_robot_multi_joint.py, SURVEY.md §2.8): no
transformer, no conditioning. The 12 leg-joint trajectory window is
flattened into one vector, denoised by a two-layer LeakyReLU MLP with a
sinusoidal timestep embedding added in hidden space, and sampled
unconditionally with DDIM. The reference reads joint_commands.csv, windows
70 steps subsampled ::3, normalizes per joint and squashes with tanh
(train_robot_multi_joint.py:53-96); here the same recipe runs against a
dataset DB's JointCommands rows (dummy-synthesized when no --db is given,
standing in for fetch_data) on the port's diffusion core.

  python -m soccerdiffusion_tpu_torch.examples.mlp_denoiser_multijoint [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from soccerdiffusion_tpu_torch.data.schema import connect
from soccerdiffusion_tpu_torch.diffusion import add_noise, ddim_sample, make_schedule
from soccerdiffusion_tpu_torch.examples import lecun_normal, resolve_device

# The reference's 12 leg joints (train_robot_multi_joint.py:57-71), in its
# order; window 70 after ::3 subsampling (:84-90).
LEG_JOINTS = (
    "LHipYaw", "LHipRoll", "LHipPitch", "LKnee", "LAnklePitch", "LAnkleRoll",
    "RHipYaw", "RHipRoll", "RHipPitch", "RKnee", "RAnklePitch", "RAnkleRoll",
)
WINDOW, SUBSAMPLE = 70, 3


class MLPDenoiser(nn.Module):
    """joint_enc -> (+ timestep embedding) -> joint_dec on the flattened
    trajectory (reference train_robot_multi_joint.py:12-27); LeakyReLU at
    flax's and torch's slope 0.01."""

    def __init__(self, flat_dim: int = WINDOW * len(LEG_JOINTS), hidden: int = 1024):
        super().__init__()
        self.hidden = hidden
        self.enc, self.mid, self.dec = (nn.Linear(flat_dim, hidden), nn.Linear(hidden, hidden),
                                        nn.Linear(hidden, flat_dim))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.enc(x.reshape(x.shape[0], -1)))
        # sinusoidal timestep embedding (reference :30-41)
        half = self.hidden // 2
        freqs = torch.exp(-math.log(10000.0) / (half - 1)
                          * torch.arange(half, dtype=torch.float32, device=x.device))
        emb = t[:, None].float() * freqs[None, :]
        h = h + torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        h = F.leaky_relu(self.mid(h))
        return self.dec(h).reshape(x.shape)


@torch.no_grad()
def load_jax_params(model: MLPDenoiser, params) -> MLPDenoiser:
    """Copy the JAX ``MLPDenoiser``'s flax parameters (numpy leaves;
    ``{"params": ...}`` or the inner dict: ``Dense_0`` -> ``enc``,
    ``Dense_1`` -> ``mid``, ``Dense_2`` -> ``dec``) into ``model``."""
    tree = params.get("params", params)
    for i, lin in enumerate((model.enc, model.mid, model.dec)):
        kernel, bias = (np.asarray(tree[f"Dense_{i}"][k], np.float32) for k in ("kernel", "bias"))
        if kernel.T.shape != tuple(lin.weight.shape):
            raise ValueError(f"Dense_{i}: kernel {kernel.shape}, the port's (in, out) is "
                             f"{tuple(lin.weight.shape[::-1])}")
        lin.weight.copy_(torch.tensor(kernel.T))
        lin.bias.copy_(torch.tensor(bias))
    return model


def flax_init(model: MLPDenoiser, seed: int) -> dict:
    """Flax's Dense initialisers for ``model`` (kernels ``lecun_normal``,
    zero biases), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i, lin in enumerate((model.enc, model.mid, model.dec)):
        fan_out, fan_in = lin.weight.shape
        tree[f"Dense_{i}"] = {"kernel": lecun_normal(rng, (fan_in, fan_out), fan_in),
                              "bias": np.zeros(fan_out, np.float32)}
    return tree


def leg_windows(db: str) -> np.ndarray:
    """(N, WINDOW, 12) tanh-squashed per-joint-normalized windows from the
    DB's JointCommands rows (reference :53-96, CSV -> sqlite)."""
    conn = connect(db, read_only=True)
    cols = ", ".join(f'"{j}"' for j in LEG_JOINTS)
    rows = conn.execute(
        f"SELECT {cols} FROM JointCommands ORDER BY recording_id, stamp"
    ).fetchall()
    conn.close()
    data = np.asarray(rows, dtype=np.float32)[::SUBSAMPLE]
    data = (data - data.mean(0)) / (data.std(0) + 1e-6)
    wins = np.stack([data[i : i + WINDOW] for i in range(len(data) - WINDOW)])
    return np.tanh(wins)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Unconditional MLP denoiser over leg trajectories")
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    db = args.db
    if db is None:
        from soccerdiffusion_tpu_torch.cli import main as cli

        db = str(Path(tempfile.mkdtemp()) / "mlp_prelim.sqlite3")
        cli(["db", "create-schema", "--db", db])
        cli(["db", "dummy-data", "-n", "2", "-s", "1500", "-i", "50", "--db", db])

    wins = leg_windows(db)
    print(f"{len(wins)} windows of ({WINDOW}, {len(LEG_JOINTS)}) from {db}")
    data = torch.from_numpy(wins).to(device)

    model = MLPDenoiser()
    model = load_jax_params(model, flax_init(model, 0)).to(device)
    sched = make_schedule(1000)  # reference num_train_timesteps (:47-48)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)  # optax.adam
    generator = torch.Generator(device=device).manual_seed(0)

    rng = np.random.default_rng(0)
    t0, losses = time.time(), []
    for i in range(args.steps):
        batch = data[torch.from_numpy(rng.integers(0, len(wins), 64)).to(device)]
        t = torch.randint(0, 1000, (batch.shape[0],), generator=generator, device=device)
        noise = torch.randn(batch.shape, generator=generator, device=device)
        noisy = add_noise(sched, batch, noise, t)
        loss = torch.mean((model(noisy, t) - noise) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % 500 == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s; "
          f"final {np.mean(losses[-10:]):.4f}")

    # Unconditional DDIM sampling (the reference samples 30 steps with the
    # DDIM scheduler); check the generated population's per-joint spread
    # against the data's: the unconditional archetype's fit criterion.
    noise = torch.randn((64, WINDOW, 12), device=device,
                        generator=torch.Generator(device=device).manual_seed(7))
    with torch.no_grad():
        traj = ddim_sample(
            sched, lambda x, t: model(x, torch.full((64,), t, dtype=torch.int64, device=device)),
            noise, 30, clip_x0=1.0).cpu().numpy()  # DDIMScheduler default clip_sample=True
    data_std, gen_std = float(wins.std()), float(traj.std())
    print(f"per-element std: data {data_std:.3f} vs sampled {gen_std:.3f}; "
          f"range [{traj.min():.2f}, {traj.max():.2f}]")
    ok = (np.mean(losses[-10:]) < 0.5 * losses[0]
          and np.isfinite(traj).all()
          and 0.3 < gen_std / data_std < 3.0)
    print("MLP MULTI-JOINT PASSED" if ok else "MLP MULTI-JOINT FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
