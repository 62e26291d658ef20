"""Bit-level fingerprints of the encoder-layer kernels (the fused ViT block
and the fused encoder stack, forward and backward), of the whole-chunk
sampler (head_dim 32, 64 and 128, DDIM and DPM-Solver++, a robot in a
2-block cluster and two robots an SM) and of the serving denoiser (head_dim
32, 64 and 128, eps and in-kernel DDIM forms) on fixed seeded inputs.

The encoder layer's device code (``csrc/encoder_layer.cuh`` over
``csrc/mma.cuh``) is shared with the decoder layer, flash attention and the
context encoder; the decoder pass (``csrc/decoder_pass.cuh``) is shared by
the chunk sampler and the denoiser. A change to shared code must leave
these kernels' outputs bit for bit as they were.
``tests/test_torch_cuda.py::test_layer_kernels_bit_identical_to_record``
holds them to ``tests/data/layer_kernels_golden.json``, which this script
wrote on an NVIDIA H100: the layer kernels' entries from the kernels before
the attention tiles took separate q and k / v operands, the chunk sampler's
from its kernel before its pass moved into ``decoder_pass.cuh``, the
denoiser's from its kernel on that shared pass, the head_dim-128 entries
from the first kernels at that head dim, once they held their plain
versions at every tested shape:

    python tests/cuda_golden.py OUT.json

(with ``PYTHONPATH`` at another checkout to fingerprint its kernels). Needs
the card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

# (label, op, width, heads, gelu, tokens, frames or robots)
CASES = [
    ("vit_hd64_quick", "vit", 256, 4, "quick", 64, 5),
    ("vit_hd32_exact", "vit", 128, 4, "exact", 49, 3),
    ("stack_hd32", "stack", 128, 4, None, 100, 3),
    ("stack_hd64", "stack", 128, 2, None, 10, 5),
]


def _weights(W, FF, L, seed):
    rng = np.random.default_rng(seed)
    shapes = [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,), (W,), (W,), (W, FF), (FF,),
              (FF, W), (W,)]
    w = []
    for i, s in enumerate(shapes):
        shape = s if L is None else (L, *s)
        a = rng.normal(size=shape) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=shape)
        w.append(torch.from_numpy((a + (1.0 if i in (0, 6) else 0.0)).astype(np.float32)))
    return w


def _digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]
    return hashlib.sha256(t.view(as_int).cpu().numpy().tobytes()).hexdigest()


# (label, hidden width, decoder heads, in-kernel DDIM coefficients or None)
DENOISE_CASES = [
    ("denoise_hd32_eps", 128, 4, None),
    ("denoise_hd32_ddim", 128, 4, [1.3, 0.8, 0.9, 0.4]),
    ("denoise_hd64_eps", 256, 4, None),
    ("denoise_hd64_ddim", 256, 4, [1.3, 0.8, 0.9, 0.4]),
    ("denoise_hd128_eps", 512, 4, None),
    ("denoise_hd128_ddim", 512, 4, [1.3, 0.8, 0.9, 0.4]),
]


def _serving_model(E, H, device):
    """A seeded random h128-shaped policy (P=10, J=20, 4 decoder layers) at
    hidden width E with H decoder heads, bf16."""
    from soccerdiffusion_tpu_torch.config import ModelConfig
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

    cfg = ModelConfig(num_joints=20, hidden_dim=E, num_decoder_heads=H,
                      trajectory_prediction_length=10, use_images=False,
                      compute_dtype="bfloat16", attention_impl="xla")
    model = DiffusionPolicy(cfg)
    return cfg, load_jax_params(model, *random_jax_params(model, seed=E)).to(device)


def denoise_fingerprints(device="cuda") -> dict:
    """label -> {"out": sha256} of one denoiser pass for every DENOISE_CASES
    entry: 13 robots over S=301 context K/V rows, packed by the denoiser's
    own ``pack_context_kv``."""
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser

    out = {}
    for label, E, H, coefs in DENOISE_CASES:
        cfg, model = _serving_model(E, H, device)
        den = FusedDenoiser(model)
        rng = np.random.default_rng(E + H)
        t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
        L, b, S = cfg.num_decoder_layers, 13, 301
        ck, cv = t(L, b, S, E).to(torch.bfloat16), t(L, b, S, E).to(torch.bfloat16)
        noisy, stk, stv = t(b, 10, 20), t(L, E).to(torch.bfloat16), t(L, E).to(torch.bfloat16)
        heads = lambda x: x.reshape(b, S, H, E // H)
        packed = den.pack_context_kv([(heads(ck[l]), heads(cv[l])) for l in range(L)])
        with torch.no_grad():
            y = den.run_kernel(packed, noisy, stk, stv, coefs)
        torch.cuda.synchronize()
        out[label] = {"out": _digest(y)}
    return out


# (label, hidden width, decoder heads, solver, robots, context tokens): a
# robot in a 2-block cluster (B <= 66) and, at head_dim 32, two 8-warp
# blocks an SM (B > 132); the h128 and flagship contexts, and larger_model's
# head_dim 128 at S=311
CHUNK_CASES = [
    (f"chunk_hd{E // 4}_{solver}_b{b}", E, 4, solver, b, S)
    for E, S in ((128, 301), (256, 311), (512, 311)) for solver in ("ddim", "dpmpp")
    for b in (13, 133)
]


def chunk_fingerprints(device="cuda") -> dict:
    """label -> {"out": sha256} of one 30-step chunk for every CHUNK_CASES entry."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler

    out = {}
    for label, E, H, solver, b, S in CHUNK_CASES:
        _, model = _serving_model(E, H, device)
        chunk = FusedChunkSampler(model)
        rng = np.random.default_rng(b + S)
        t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
        context, noise = t(b, S, E).to(torch.bfloat16), t(b, 10, 20)
        with torch.no_grad():
            stk, stv = chunk.step_tables(t(30, E))
            y = chunk.sample_kernel(context, noise, stk, stv,
                                    solver_coef_table(make_schedule(1000), 30, solver))
        torch.cuda.synchronize()
        out[label] = {"out": _digest(y)}
    return out


def fingerprints(device="cuda") -> dict:
    """label -> {output name: sha256 of its bytes} for every case."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    out = {}
    for label, op, W, H, gelu, T, n in CASES:
        w = [t.to(device, torch.bfloat16)
             for t in _weights(W, 4 * W if op == "vit" else W, None if op == "vit" else 2, T)]
        rng = np.random.default_rng(T + n)
        x, dy = (torch.from_numpy(rng.normal(size=(n, T, W)).astype(np.float32)).to(
            device, torch.bfloat16) for _ in range(2))
        if op == "vit":
            y = fvb.forward_kernel(x, w, H, gelu)
            dx, grads = fvb.backward_kernel(x, dy, w, H, gelu)
        else:
            y, acts = fes.forward_kernel(x, w, H)
            dx, grads = fes.backward_kernel(acts, dy, w, H)
        torch.cuda.synchronize()
        out[label] = {"y": _digest(y), "dx": _digest(dx),
                      **{f"d{name}": _digest(g) for name, g in zip(fes.STACK_WEIGHTS, grads)}}
    return {**out, **chunk_fingerprints(device), **denoise_fingerprints(device)}


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python tests/cuda_golden.py OUT.json (on a machine with an NVIDIA GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"gpu": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "cuda": torch.version.cuda, "fingerprints": fingerprints()}
    with open(sys.argv[1], "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print(json.dumps(record["fingerprints"], sort_keys=True))
