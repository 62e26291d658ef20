"""How far the decoder kernels' bf16 outputs lie from their plain
versions, beside how far those plain versions lie from float32: the
denoiser (eps and in-kernel DDIM forms, at DDIM steps 0, 3 and 29 of 30)
and the 30-step DDIM chunk sampler on chip_smoke.py's larger_model inputs
(B=64 robots, S=311 context tokens from a random batch with cached image
tokens), for larger_model.yaml's decoder (head_dim 128, 8 layers) and 4
layers of it, and the flagship's width (head_dim 64, hidden 256, 4 layers),
each with ``random_jax_params`` weights (biases and LayerNorm parameters
off 0 and 1) and with ``flax_init_params`` (the YAML's initial weights).

    python tools/decoder_bf16_spread.py

Per case: max |a - b| / max |b| of kernel vs bf16 plain, bf16 plain vs
float32 plain (the same weights, no bf16 rounding) and kernel vs float32
plain, and the five robots farthest from the plain version. Needs an
NVIDIA GPU; builds the kernels like chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table  # noqa: E402
from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps  # noqa: E402
from soccerdiffusion_tpu_torch.models import DiffusionPolicy  # noqa: E402
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler  # noqa: E402
from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser  # noqa: E402
from soccerdiffusion_tpu_torch.utils.jax_params import (flax_init_params, load_jax_params,  # noqa: E402
                                                        random_jax_params)

B, DDIM = 64, [1.3, 0.8, 0.9, 0.4]


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def worst_robots(a, b) -> list:
    a, b = a.float(), b.float()
    e = (a - b).abs().flatten(1).max(1).values / b.abs().max()
    return [round(x, 4) for x in np.sort(e.cpu().numpy())[-5:].tolist()]


def model_pair(cfg, init):
    """The bf16 model and its float32 twin with the same weights."""
    draw = random_jax_params if init == "random" else flax_init_params
    out = []
    for dtype in ("bfloat16", "float32"):
        m = DiffusionPolicy(dataclasses.replace(cfg, compute_dtype=dtype))
        out.append(load_jax_params(m, *draw(m, 5)).to("cuda").eval())
    return out


def case(label, cfg, init):
    model, m32 = model_pair(cfg, init)
    rng = np.random.default_rng(1100)
    batch = cs.random_batch(cfg, B, "cuda", rng)
    batch["image_tokens"] = torch.from_numpy(rng.normal(
        size=(B, cfg.image_context_length, cfg.hidden_dim)).astype(np.float32)).cuda()
    context = model.encode_context(batch)
    noise = torch.from_numpy(rng.normal(size=(B, 10, 20)).astype(np.float32)).cuda()
    den, den32 = FusedDenoiser(model), FusedDenoiser(m32)
    table = model.step_encoding(torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64),
                                                device="cuda"))[:, 0]
    stk, stv = den.step_tables(table)
    packed = den.pack_context_kv(model.precompute_context_kv(context))
    name = f"{label}, {init} weights, B={B}, S={context.shape[1]}"
    for step in (0, 3, 29):
        for coefs in (None, DDIM):
            k = den.run_kernel(packed, noise, stk[step], stv[step], coefs)
            p = den.run_plain(packed, noise, stk[step], stv[step], coefs)
            p32 = den32.run_plain(packed, noise, stk[step], stv[step], coefs)
            print(f"{name}: denoiser step {step} {'eps' if coefs is None else 'ddim'}: "
                  f"kernel-plain {rel(k, p):.4f}, plain-float32 {rel(p, p32):.4f}, "
                  f"kernel-float32 {rel(k, p32):.4f}; farthest robots {worst_robots(k, p)}",
                  flush=True)
    chunk, chunk32 = FusedChunkSampler(model), FusedChunkSampler(m32)
    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    k = chunk.sample_kernel(context, noise, stk, stv, coefs)
    p = chunk.sample_plain(context, noise, stk, stv, coefs)
    p32 = chunk32.sample_plain(context, noise, stk, stv, coefs)
    print(f"{name}: chunk ddim30: kernel-plain {rel(k, p):.4f}, plain-float32 {rel(p, p32):.4f}, "
          f"kernel-float32 {rel(k, p32):.4f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("decoder_bf16_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    larger = cs.larger_config()
    cases = [("larger_model hd128 L=8", larger),
             ("larger_model hd128 L=4", dataclasses.replace(larger, num_decoder_layers=4)),
             ("hidden 256 hd64 L=4", dataclasses.replace(larger, hidden_dim=256,
                                                         num_decoder_layers=4))]
    with torch.no_grad():
        for label, cfg in cases:
            for init in ("random", "flax"):
                case(label, cfg, init)
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
