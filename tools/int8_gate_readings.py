"""The int8 chunk kernel's readings against its gates, at every robot block
and head dim that chip_smoke.py's phase 17 checks, each check reported
instead of stopping the run: chip_smoke.py's ``int8_checks`` (one step and
30 against the plain version, the kernel's record of every (step, layer)
against the plain quantiser and cross-attention, and their controls) run
one R at a time, at h128 (S=301) B=64 for R = 8, 16, 1, 2, 4, 32 and
B=1024 for R = 16, at the flagship's head_dim 64 and larger_model's
head_dim 128 (B=64) for R = 8, 16; and at h128 B=64 the bf16 chunk,
denoiser and "qstat" kernels against their plain versions. Use it to set
or review the limits (chip_smoke.py: CROSS_EQUAL_SHARE, INT8_RMS_SHARE).

    python tools/int8_gate_readings.py

Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table  # noqa: E402
from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps  # noqa: E402
from soccerdiffusion_tpu_torch.ops import _build  # noqa: E402
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler  # noqa: E402
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder  # noqa: E402

DEV = "cuda"


def each(model, context, noise, b, name, blocks):
    """int8_checks at each R alone; a failed gate is logged, not raised."""
    for R in blocks:
        try:
            with torch.no_grad():
                cs.int8_checks(model, context, noise, DEV, b, name, (R,), (R,))
        except AssertionError as e:
            cs.log("GATE FAILED", e)


def with_tokens(model, b, rng):
    """A random batch with image tokens, encoded, and its noise."""
    cfg = model.config
    batch = cs.random_batch(cfg, b, DEV, rng)
    tokens = rng.normal(size=(b, cfg.image_context_length, cfg.hidden_dim))
    batch["image_tokens"] = torch.from_numpy(tokens.astype(np.float32)).to(DEV)
    context = model.encode_context(batch)
    return context, torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(DEV)


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_gate_readings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    model = cs.build_model(cs.bench_config(), DEV)
    enc = FusedContextEncoder(model)
    for b, blocks in ((64, (8, 16, 1, 2, 4, 32)), (cs.BENCH_B, (16,))):
        rng = np.random.default_rng(1700 + b)
        with torch.no_grad():
            context = enc.encode_plain(cs.random_batch(model.config, b, DEV, rng))
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(DEV)
        each(model, context, noise, b, "h128", blocks)
        if b != 64:
            continue
        try:
            with torch.no_grad():
                cs.decoder_checks(model, context, noise, DEV, b)
                qs = FusedChunkSampler(model, cross_orientation="qstat")
                steps = torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64), device=DEV)
                stk, stv = qs.step_tables(model.step_encoding(steps)[:, 0])
                coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
                cs.compare("fused_chunk_qstat",
                           lambda: qs.sample_kernel(context, noise, stk, stv, coefs),
                           lambda: qs.sample_plain(context, noise, stk, stv, coefs), b, 0, [])
        except AssertionError as e:
            cs.log("GATE FAILED", e)
    del model, enc
    torch.cuda.empty_cache()
    flag = cs.build_model(cs.flagship_config(), DEV, seed=3)
    with torch.no_grad():
        context, noise = with_tokens(flag, cs.FLAG_B, np.random.default_rng(1764))
    each(flag, context, noise, cs.FLAG_B, "hd64", (8, 16))
    del flag
    torch.cuda.empty_cache()
    larger = cs.larger_model(DEV)
    with torch.no_grad():
        context, noise = with_tokens(larger, cs.LARGER_B, np.random.default_rng(1791))
    each(larger, context, noise, cs.LARGER_B, "hd128", (8, 16))
    cs.log(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
