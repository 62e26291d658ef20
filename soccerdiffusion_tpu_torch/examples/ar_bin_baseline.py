"""Tiny-tier example: autoregressive discretized-bin gait baseline
(counterpart of ``examples/ar_bin_baseline.py``).

The reference's preliminary AR baseline (ml/preliminary/train_robot_dis.py:
15-47): per-timestep tokens are the concatenation of one-hot joint-angle
bins, a causal transformer predicts every joint's NEXT-step bin with
cross-entropy, and sampling is greedy top-1 from a zero start token. It is
the discrete / AR foil to the diffusion policy
(``examples/sine_diffusion_toy.py``) on the same kind of synthetic gait data
(SURVEY.md §2.8). The one-hot @ embedding matrix is a per-joint table
gather (the same product, without the (J * num_bins)-wide one-hot).

  python -m soccerdiffusion_tpu_torch.examples.ar_bin_baseline [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from soccerdiffusion_tpu_torch.examples import lecun_normal, resolve_device

SEQ, JOINTS, BINS = 48, 4, 32
HIDDEN, HEADS, LAYERS = 64, 4, 2  # reference: hidden 128, 1 layer, 4 heads
TRAIN_STEPS = 800
LN_EPS = 1e-6  # flax's LayerNorm


def gait_bins(rng: np.random.Generator, batch: int) -> np.ndarray:
    """Synthetic multi-frequency gait, tanh-squashed to (-1, 1) and
    discretized to BINS bins: the reference's CSV pipeline shape
    (train_robot_dis.py:92-120) on procedural data. (B, SEQ, JOINTS) int32."""
    freqs = rng.uniform(0.5, 1.5, (batch, JOINTS))
    phases = rng.uniform(0, 2 * np.pi, (batch, JOINTS))
    amps = rng.uniform(0.6, 1.4, (batch, JOINTS))
    t = np.arange(SEQ) * 0.15
    waves = amps[:, None, :] * np.sin(
        freqs[:, None, :] * t[None, :, None] + phases[:, None, :])
    scaled = (np.tanh(waves) + 1.0) / 2.0  # [0, 1]
    return np.minimum((scaled * BINS).astype(np.int32), BINS - 1)


def positional_encoding() -> torch.Tensor:
    """The fixed sin / cos table (SEQ, HIDDEN)."""
    pos = np.zeros((SEQ, HIDDEN), np.float32)
    div = np.exp(np.arange(0, HIDDEN, 2) * (-np.log(10000.0) / HIDDEN))
    pos[:, 0::2] = np.sin(np.arange(SEQ)[:, None] * div)
    pos[:, 1::2] = np.cos(np.arange(SEQ)[:, None] * div)
    return torch.from_numpy(pos)


class CausalLayer(nn.Module):
    """Post-norm layer: causal self-attention (flax's
    MultiHeadDotProductAttention), then a GELU MLP (tanh GELU, flax's
    default)."""

    def __init__(self):
        super().__init__()
        self.query, self.key, self.value, self.out = (nn.Linear(HIDDEN, HIDDEN) for _ in range(4))
        self.norm1, self.norm2 = nn.LayerNorm(HIDDEN, eps=LN_EPS), nn.LayerNorm(HIDDEN, eps=LN_EPS)
        self.dense1, self.dense2 = nn.Linear(HIDDEN, HIDDEN), nn.Linear(HIDDEN, HIDDEN)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        heads = lambda y: y.view(b, length, HEADS, HIDDEN // HEADS).transpose(1, 2)
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = q @ k.transpose(-1, -2) / math.sqrt(HIDDEN // HEADS)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        a = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, length, HIDDEN)
        x = self.norm1(x + self.out(a))
        return self.norm2(x + self.dense2(F.gelu(self.dense1(x), approximate="tanh")))


class CausalBinTransformer(nn.Module):
    """Causal transformer over per-timestep joint-bin tokens.

    Reference layer semantics (train_robot_dis.py:15-47): linear embed of
    the joint x bin token, fixed sin / cos posenc, pre-softmax causal mask,
    per-joint bin logits. The unused zero-memory cross-attention of the
    torch TransformerDecoder is dropped (it is a constant)."""

    def __init__(self):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(JOINTS, BINS, HIDDEN))
        self.layers = nn.ModuleList(CausalLayer() for _ in range(LAYERS))
        self.head = nn.Linear(HIDDEN, JOINTS * BINS)
        self.register_buffer("pos", positional_encoding(), persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L, J) bins -> (B, L, J, BINS) logits."""
        b, length, j = tokens.shape
        x = self.embed[torch.arange(j, device=tokens.device), tokens.long()].sum(dim=2)
        x = x + self.pos[None, :length]
        mask = torch.ones((length, length), dtype=torch.bool, device=tokens.device).tril()
        for layer in self.layers:
            x = layer(x, mask)
        return self.head(x).reshape(b, length, j, BINS)


def flax_names(model: CausalBinTransformer):
    """(flax path, port tensor, kind) for every parameter: the names flax's
    auto-naming gives the JAX module's parameters (the outer Dense of the
    MLP is created before the inner one)."""
    yield ("embed",), model.embed, "raw"
    for i, layer in enumerate(model.layers):
        mha = f"MultiHeadDotProductAttention_{i}"
        for name in ("query", "key", "value", "out"):
            lin = getattr(layer, name)
            yield (mha, name, "kernel"), lin.weight, "out" if name == "out" else "qkv"
            yield (mha, name, "bias"), lin.bias, "flat"
        for k, norm in enumerate((layer.norm1, layer.norm2)):
            yield (f"LayerNorm_{2 * i + k}", "scale"), norm.weight, "raw"
            yield (f"LayerNorm_{2 * i + k}", "bias"), norm.bias, "raw"
        for k, lin in enumerate((layer.dense2, layer.dense1)):
            yield (f"Dense_{2 * i + k}", "kernel"), lin.weight, "dense"
            yield (f"Dense_{2 * i + k}", "bias"), lin.bias, "raw"
    yield (f"Dense_{2 * LAYERS}", "kernel"), model.head.weight, "dense"
    yield (f"Dense_{2 * LAYERS}", "bias"), model.head.bias, "raw"


@torch.no_grad()
def load_jax_params(model: CausalBinTransformer, params) -> CausalBinTransformer:
    """Copy a flax parameter tree of the JAX ``CausalBinTransformer`` (numpy
    leaves; ``{"params": ...}`` or the inner dict) into ``model``."""
    tree = params.get("params", params)
    for path, tensor, kind in flax_names(model):
        value = tree
        for key in path:
            value = value[key]
        value = np.asarray(value, np.float32)
        if kind in ("qkv", "dense"):  # (in, heads, head_dim) / (in, out) -> (out, in)
            value = value.reshape(value.shape[0], -1).T
        elif kind == "out":  # (heads, head_dim, out) -> (out, in)
            value = value.reshape(-1, value.shape[-1]).T
        elif kind == "flat":
            value = value.reshape(-1)
        if value.shape != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(path)}: shape {value.shape}, the port's "
                             f"{tuple(tensor.shape)}")
        tensor.copy_(torch.tensor(value))
    return model


def flax_init(seed: int) -> dict:
    """A parameter tree drawn from flax's initialisers for the module (the
    embedding normal(0.02); Dense and attention kernels ``lecun_normal``;
    zero biases; unit LayerNorm scales), with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    lecun = lambda shape, fan_in: lecun_normal(rng, shape, fan_in)
    head_dim = HIDDEN // HEADS
    tree = {"embed": (0.02 * rng.standard_normal((JOINTS, BINS, HIDDEN))).astype(np.float32)}
    for i in range(LAYERS):
        mha = {name: {"kernel": lecun((HIDDEN, HEADS, head_dim), HIDDEN),
                      "bias": np.zeros((HEADS, head_dim), np.float32)}
               for name in ("query", "key", "value")}
        mha["out"] = {"kernel": lecun((HEADS, head_dim, HIDDEN), HIDDEN),
                      "bias": np.zeros(HIDDEN, np.float32)}
        tree[f"MultiHeadDotProductAttention_{i}"] = mha
        for k in range(2):
            tree[f"LayerNorm_{2 * i + k}"] = {"scale": np.ones(HIDDEN, np.float32),
                                              "bias": np.zeros(HIDDEN, np.float32)}
            tree[f"Dense_{2 * i + k}"] = {"kernel": lecun((HIDDEN, HIDDEN), HIDDEN),
                                          "bias": np.zeros(HIDDEN, np.float32)}
    tree[f"Dense_{2 * LAYERS}"] = {"kernel": lecun((HIDDEN, JOINTS * BINS), HIDDEN),
                                   "bias": np.zeros(JOINTS * BINS, np.float32)}
    return tree


def shift_right(tokens: torch.Tensor) -> torch.Tensor:
    """The model's input: a zero start token, then every token but the last."""
    return F.pad(tokens[:, :-1], (0, 0, 1, 0))


@torch.no_grad()
def ar_rollout(model: CausalBinTransformer, prompt: torch.Tensor) -> torch.Tensor:
    """Greedy top-1 continuation of (B, P, J) prompt bins to SEQ steps: each
    position's bins are the argmax of the logits of the buffer so far (the
    reference's sample_trajectory, train_robot_dis.py:185-225)."""
    buf = F.pad(prompt, (0, 0, 0, SEQ - prompt.shape[1]))
    for i in range(prompt.shape[1], SEQ):
        buf[:, i] = model(shift_right(buf))[:, i].argmax(-1).to(buf.dtype)
    return buf


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Autoregressive discretized-bin gait baseline")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    model = load_jax_params(CausalBinTransformer(), flax_init(0)).to(device)
    # optax.adamw(1e-3)'s constants
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    t0 = time.time()
    losses = []
    for i in range(TRAIN_STEPS):
        tokens = torch.from_numpy(gait_bins(rng, 32)).long().to(device)
        logits = model(shift_right(tokens))  # next-step CE on all positions
        loss = F.cross_entropy(logits.reshape(-1, BINS), tokens.reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % 200 == 0:
            print(f"step {i}: ce {losses[-1]:.3f}")
    final_ce = float(np.mean(losses[-10:]))
    print(f"trained {TRAIN_STEPS} steps in {time.time()-t0:.1f}s; final ce {final_ce:.3f} "
          f"(uniform baseline {np.log(BINS):.3f})")

    # Held-out next-step accuracy (teacher-forced), then greedy AR rollout
    # from a 12-step prompt.
    model.eval()
    test = torch.from_numpy(gait_bins(rng, 64)).long().to(device)
    with torch.no_grad():
        logits = model(shift_right(test))
    acc = float((logits.argmax(-1) == test).float().mean())
    print(f"held-out next-step bin accuracy: {acc:.3f} (chance {1 / BINS:.3f})")

    prompt_len = 12
    rolled = ar_rollout(model, test[:, :prompt_len])
    # Greedy AR continuations compound errors, so gate on the horizon the
    # policy actually serves (the production chunk is 10 ticks): mean
    # |bin error| over the 10 steps after the prompt, vs ~BINS/3 for
    # uniform noise. The full-horizon drift is reported for the record.
    horizon = 10
    near = float((rolled[:, prompt_len:prompt_len + horizon]
                  - test[:, prompt_len:prompt_len + horizon]).abs().float().mean())
    far = float((rolled[:, prompt_len:] - test[:, prompt_len:]).abs().float().mean())
    print(f"AR continuation mean |bin error|: {near:.2f} over {horizon} steps"
          f" / {far:.2f} over {SEQ - prompt_len}"
          f" (uniform-noise baseline ~{BINS / 3:.1f})")

    ok = final_ce < 1.2 and acc > 0.35 and near < 4.0
    print("AR BIN BASELINE PASSED" if ok else "AR BIN BASELINE FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
