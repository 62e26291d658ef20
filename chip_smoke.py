"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the torch / CUDA versions and the card's name and power limit.
2. Builds the CUDA kernels of soccerdiffusion_tpu_torch/csrc (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes (h128, S=301 context tokens, 30 DDIM steps, B=64
   and B=1024; bf16 weights from a seeded flax-layout random init) and
   times both with CUDA events.
4. Drives the serving loop through RolloutEngine.make_rollout_fn at the
   bench configuration (default.yaml architecture without images, bf16,
   B=1024): 5 replan periods of 30-step DDIM with the fused encoder + chunk
   kernels, then 5 of the 1-step distilled student through the fused
   denoiser, with every launch counter zeroed just before and read just
   after; then checks a short rollout of the kernel path against the same
   engine's plain versions on the CPU.
5. Prints one JSON line of per-kernel results, then as its last line
   {"ok": true, "device": {...}}.

Exits non-zero, without the last line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# kernel-vs-plain tolerance on the card, as a share of the output's scale:
# max |kernel - plain| <= TOL * max |plain|. Both sides round to bf16 at the
# same points, so they differ by fp32 summation order plus the bf16
# roundings that order flips (2^-8 = 0.4% of the value each), carried
# through the layers and, for the chunk, 30 solver steps. The seeded random
# model is untrained: its eps is not unit-scale and the DDIM chunk grows to
# |x| ~ 1e3, so an absolute bound would mean nothing. Measured on an H100:
# kernel - plain ~0.5% of scale at every step count, bf16 plain - fp32
# plain ~1.4% after 30 steps (PERF.md).
TOL = {"fused_encoder": 2e-2, "fused_denoise": 2e-2, "fused_chunk": 2e-2}
ROLLOUT_TOL = 2e-2  # the same bound on each replan period's chunk
BENCH_B, CHUNKS = 1024, 5


def log(*a):
    print(*a, flush=True)


def bench_config():
    from soccerdiffusion_tpu_torch.config import ModelConfig

    return ModelConfig(  # bench.py:73-90 with its defaults (patch 1, bf16)
        num_joints=20, hidden_dim=128, trajectory_prediction_length=10,
        action_context_length=100, joint_state_context_length=100, imu_context_length=100,
        use_images=False, use_gamestate=True, num_action_history_encoder_layers=2,
        num_imu_encoder_layers=2, joint_state_encoder_layers=2, num_decoder_layers=4,
        encoder_patch_size=1, compute_dtype="bfloat16")


def build_model(cfg, device, seed=1):
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

    model = DiffusionPolicy(cfg)
    return load_jax_params(model, random_jax_params(model, seed)).to(device).eval()


def random_batch(cfg, b, device, rng):
    t = lambda a: torch.from_numpy(a).to(device)
    return {
        "joint_command_history": t(rng.uniform(0, 2 * np.pi, (b, 100, 20)).astype(np.float32)),
        "rotation": t(rng.normal(size=(b, 100, cfg.imu_input_dim)).astype(np.float32)),
        "joint_state": t(rng.uniform(0, 2 * np.pi, (b, 100, 20)).astype(np.float32)),
        "game_state": t(rng.integers(0, 4, (b,))),
    }


def median_ms(fn, reps=5, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel_fn, plain_fn, b):
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name} B={b}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                             "or non-finite output")
    max_abs = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = max_abs <= TOL[name] * scale
    k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
    log(f"{name} B={b}: max_abs_err={max_abs:.4e} max|plain|={scale:.4e} "
        f"(tol {TOL[name]} x max|plain|) kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} B={b} disagrees with its plain version")
    return max_abs, k_ms, p_ms


def kernel_phase(cfg, model, device):
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder

    enc, den, chunk = FusedContextEncoder(model), FusedDenoiser(model), FusedChunkSampler(model)
    schedule = make_schedule(1000)
    ts = ddim_timesteps(1000, 30)
    coefs = solver_coef_table(schedule, 30, "ddim")
    results = {}
    for b in (64, BENCH_B):
        rng = np.random.default_rng(b)
        batch = random_batch(cfg, b, device, rng)
        with torch.no_grad():
            r_enc = compare("fused_encoder", lambda: enc.encode_kernel(batch),
                            lambda: enc.encode_plain(batch), b)
            context = enc.encode_plain(batch)
            table = model.step_encoding(torch.as_tensor(ts.astype(np.int64), device=device))[:, 0]
            stk, stv = chunk.step_tables(table)
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk = compare("fused_chunk",
                              lambda: chunk.sample_kernel(context, noise, stk, stv, coefs),
                              lambda: chunk.sample_plain(context, noise, stk, stv, coefs), b)
            packed = den.pack_context_kv(model.precompute_context_kv(context))
            ddim = [1.3, 0.8, 0.9, 0.4]  # eps form and in-kernel DDIM form
            r_den = max(
                (compare("fused_denoise", lambda c=c: den.run_kernel(packed, noise, stk[3], stv[3], c),
                         lambda c=c: den.run_plain(packed, noise, stk[3], stv[3], c), b)
                 for c in (None, ddim)), key=lambda r: r[0])
        for name, r in (("fused_encoder", r_enc), ("fused_chunk", r_chunk), ("fused_denoise", r_den)):
            prev = results.get(name)
            err = r[0] if prev is None else max(prev[0], r[0])
            results[name] = (err, r[1], r[2])  # times of the last (B=1024) shape
    return results


def engine(model, cfg, device, **kw):
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference import RolloutEngine

    return RolloutEngine(model, make_schedule(1000), Normalizer.identity(cfg.num_joints),
                         num_inference_steps=30, fused_encoder=kw.pop("fused_encoder", True),
                         device=device, **kw)


def timed_rollout(eng, device, seed):
    run = eng.make_rollout_fn(CHUNKS)
    carry = eng.init(BENCH_B, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, chunks = run(carry)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / CHUNKS
    if tuple(chunks.shape) != (CHUNKS, BENCH_B, 10, 20) or not torch.isfinite(chunks).all():
        raise AssertionError(f"bad chunks: shape {tuple(chunks.shape)}, "
                             f"finite={bool(torch.isfinite(chunks).all())}")
    return ms


def main_path_phase(cfg, model, device):
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder

    counters = (FusedContextEncoder, FusedChunkSampler, FusedDenoiser)
    ddim30 = engine(model, cfg, device, fused="chunk")
    distilled = engine(model, cfg, device, distilled=True, fused=True)
    plain = engine(model, cfg, device, fused=False, fused_encoder=False)
    for eng in (ddim30, distilled, plain):  # warm-up: allocator, first launches
        eng.make_rollout_fn(1)(eng.init(BENCH_B, torch.Generator(device=device).manual_seed(0)))
    for c in counters:
        c.launches = 0
    ms_ddim = timed_rollout(ddim30, device, 1)
    ms_dist = timed_rollout(distilled, device, 2)
    launches = {c.__name__: c.launches for c in counters}
    log(f"main path B={BENCH_B}, {CHUNKS} periods each: ddim30 (fused encoder + chunk kernels) "
        f"{ms_ddim:.2f} ms/period; distilled1 (fused encoder + denoiser kernels) "
        f"{ms_dist:.2f} ms/period; launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    ms_plain = timed_rollout(plain, device, 1)
    log(f"unfused plain-PyTorch rollout (fused=False, bf16) B={BENCH_B}: {ms_plain:.2f} ms/period")
    return launches, {"ddim30": ms_ddim, "distilled1": ms_dist, "ddim30_unfused": ms_plain}


def to_device(carry, device):
    """The rollout carry on another device, with a fresh generator there."""
    move = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)})
    return dataclasses.replace(carry, controller=move(carry.controller), plant=move(carry.plant),
                               generator=torch.Generator(device=device))


def reference_phase(cfg, model, device):
    """Closed-loop periods of the kernel path, each held against the same
    engine's plain versions on the CPU from the same state and noise (the
    untrained model's loop is chaotic, so the states are re-synchronised
    every period)."""
    b = 8
    rng = np.random.default_rng(5)
    gpu = engine(model, cfg, device, fused="chunk")
    cpu = engine(copy.deepcopy(model).cpu(), cfg, "cpu", fused="chunk")
    carry = gpu.init(b, torch.Generator(device=device).manual_seed(0))
    for period in range(2):
        noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32))
        _, ref = cpu.replan_period(to_device(carry, "cpu"), noise)
        carry, got = gpu.replan_period(carry, noise)
        err, scale = (got.cpu() - ref).abs().max().item(), ref.abs().max().item()
        log(f"serving loop B={b} period {period}: kernels on {device} vs plain versions on cpu: "
            f"max_abs_err={err:.4e} max|plain|={scale:.4e} (tol {ROLLOUT_TOL} x max|plain|)")
        if not err <= ROLLOUT_TOL * scale:
            raise AssertionError("the kernel path disagrees with the plain path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from soccerdiffusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s ({_build.build_dir()})")
    build_log = _build.build_dir() / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(line.strip(), file=sys.stderr)

    cfg = bench_config()
    model = build_model(cfg, device)
    results = kernel_phase(cfg, model, device)
    launches, periods = main_path_phase(cfg, model, device)
    reference_phase(cfg, model, device)

    replaces = {
        "fused_encoder": "soccerdiffusion_tpu/ops/fused_encoder.py:319",
        "fused_chunk": "soccerdiffusion_tpu/ops/fused_chunk.py:518",
        "fused_denoise": "soccerdiffusion_tpu/ops/fused_denoise.py:382",
    }
    counter = {"fused_encoder": "FusedContextEncoder", "fused_chunk": "FusedChunkSampler",
               "fused_denoise": "FusedDenoiser"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"soccerdiffusion_tpu_torch/csrc/{name}.cu",
                "replaces": replaces[name], "launches": launches[counter[name]],
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
               for name, (err, k_ms, p_ms) in results.items()]
    log(json.dumps({"kernels": kernels, "ms_per_replan_period": periods, "batch": BENCH_B,
                    "gpu": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
