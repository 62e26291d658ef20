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
5. Holds the training kernels (fused encoder stack and fused decoder layer,
   forward and backward) against their plain versions at the training
   shapes (T=100 / L=2 encoder stacks, T=10 x S=302 decoder layers) at B=64
   and B=256: the output, the input gradients and every weight gradient.
6. Trains through training/train.py's loop (synthetic data, the bench
   configuration with encoder_fused_stack and decoder_fused_block, bf16,
   B=64, 20 steps) with the four training counters zeroed just before and
   read just after, then the same loop with both knobs off; then 3 steps
   on the card against the same 3 steps on the CPU (plain versions).
7. Prints one JSON line of per-kernel results, then as its last line
   {"ok": true, "device": {...}}.

Exits non-zero, without the last line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX.

    python3 chip_smoke.py --profile-training [--profile-out FILE]

builds the kernels and instead traces the B=64 training step (fused knobs
on, then off) with torch.profiler: per step the host wall clock, the device
busy time (the union of the device ops' intervals), the device's idle
share, both taken from the same trace, and the largest device ops. FILE
receives the full tables.
"""

from __future__ import annotations

import argparse
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
# training kernels: every output and weight gradient within TRAIN_TOL x
# max|plain| of that tensor (bf16 at the same rounding points, fp32 sums in
# another order); the key-bias gradients, zero in exact arithmetic, within
# TRAIN_TOL x the largest weight gradient of their layer instead
TRAIN_TOL = 2e-2
TRAIN_BATCHES, TRAIN_STEPS, TRAIN_BATCH = (64, 256), 20, 64
TRAIN_LOG_EVERY = 4  # two epochs of 10 steps: syncs at steps 4, 8 | 12, 16, 20
# 3 steps on the card vs on the CPU: the losses within 2e-2 relative; the
# parameter updates within 0.1 of the update norm (AdamW normalises each
# step to ~lr, so entries whose gradient is float noise, such as the key
# biases, take steps of either sign)
STEP_LOSS_TOL, STEP_UPDATE_TOL = 2e-2, 0.1


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


def err_line(name, got, ref, tol_scale=None):
    """max |got - ref| against TRAIN_TOL x tol_scale (default max|ref|)."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    tol_scale = scale if tol_scale is None else tol_scale
    ok = err <= TRAIN_TOL * tol_scale
    log(f"  {name}: max_abs_err={err:.4e} max|plain|={scale:.4e} tol={TRAIN_TOL * tol_scale:.4e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def grads_check(names, got, ref, zero):
    """Every weight gradient; those in ``zero`` (name -> last-axis slice,
    zero in exact arithmetic) against the layer's largest gradient."""
    top = max(r.float().abs().max().item() for r in ref)
    errs = []
    for name, g, r in zip(names, got, ref):
        if name in zero:
            cut = zero[name]
            errs.append(err_line(f" d{name}[exact zero part]", g[..., cut], r[..., cut], top))
            keep = torch.ones(g.shape[-1], dtype=torch.bool, device=g.device)
            keep[cut] = False
            g, r = g[..., keep], r[..., keep]
            if not g.numel():
                continue
        errs.append(err_line(f" d{name}", g, r))
    return max(errs)


def training_kernel_phase(cfg, model, device):
    """Kernels C / D (encoder stack fwd / bwd) on the action-history stack's
    weights and A / B (decoder layer fwd / bwd) on decoder layer 0's, at the
    training shapes, against their plain versions."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    H, E = 4, cfg.hidden_dim
    S = cfg.action_context_length + cfg.imu_context_length + cfg.joint_state_context_length + 2
    enc_w = [t.detach().to(torch.bfloat16) for t in
             fes.stack_weights(model.action_history_encoder.seq.encoder.layers)]
    dec_w = [t.detach().to(torch.bfloat16) for t in
             fdl.layer_weights(model.diffusion_action_generator.decoder.layers[0])]
    results = {}
    for b in TRAIN_BATCHES:
        rng = np.random.default_rng(100 + b)
        t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, torch.bfloat16)
        x, dy, xd, mem, dyd = t(b, 100, E), t(b, 100, E), t(b, 10, E), t(b, S, E), t(b, 10, E)
        log(f"encoder stack B={b} T=100 L=2 E={E}:")
        y, acts = fes.forward_kernel(x, enc_w, H)
        e_fwd = err_line("y", y, fes.forward_plain(x, enc_w, H))
        dx, grads = fes.backward_kernel(acts, dy, enc_w, H)
        dx_ref, grads_ref = fes.backward_plain(x, dy, enc_w, H)
        e_bwd = max(err_line("dx", dx, dx_ref),
                    grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(E, 2 * E)}))
        log(f"decoder layer B={b} T=10 S={S} E={E}:")
        e_dfwd = err_line("y", fdl.forward_kernel(xd, mem, dec_w, H), fdl.forward_plain(xd, mem, dec_w, H))
        ddx, dmem, dgrads = fdl.backward_kernel(xd, mem, dyd, dec_w, H)
        ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(xd, mem, dyd, dec_w, H)
        e_dbwd = max(err_line("dx", ddx, ddx_ref), err_line("dmem", dmem, dmem_ref),
                     grads_check(fdl.WEIGHT_NAMES, dgrads, dgrads_ref,
                                 {"bqkv": slice(E, 2 * E), "bck": slice(None)}))
        times = {
            "fused_encoder_stack_fwd": (e_fwd, lambda: fes.forward_kernel(x, enc_w, H),
                                        lambda: fes.forward_plain(x, enc_w, H)),
            "fused_encoder_stack_bwd": (e_bwd, lambda: fes.backward_kernel(acts, dy, enc_w, H),
                                        lambda: fes.backward_plain(x, dy, enc_w, H)),
            "fused_decoder_layer_fwd": (e_dfwd, lambda: fdl.forward_kernel(xd, mem, dec_w, H),
                                        lambda: fdl.forward_plain(xd, mem, dec_w, H)),
            "fused_decoder_layer_bwd": (e_dbwd, lambda: fdl.backward_kernel(xd, mem, dyd, dec_w, H),
                                        lambda: fdl.backward_plain(xd, mem, dyd, dec_w, H)),
        }
        for name, (err, kernel_fn, plain_fn) in times.items():
            k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
            log(f"{name} B={b}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (max_abs_err {err:.4e})")
            prev = results.get(name)
            results[name] = (err if prev is None else max(prev[0], err), k_ms, p_ms)  # B=256 times
    return results


def train_config(fused: bool):
    from soccerdiffusion_tpu_torch.config import Config, TrainConfig

    model = dataclasses.replace(bench_config(), encoder_fused_stack=fused, decoder_fused_block=fused)
    return Config(model=model, train=TrainConfig(batch_size=TRAIN_BATCH, lr=1e-4,
                                                 log_every=TRAIN_LOG_EVERY,
                                                 ema_decay=0.999))


def timed_training(fused: bool, tmp):
    """training/train.py's loop on synthetic data for TRAIN_STEPS steps in two
    epochs. ms/step is the host clock from the second epoch's first logging
    window's end to the last window's end, over the steps between: each
    window ends in a device sync and the windows run back to back, so this
    times whole steps from one sync to another, past the epoch start (the
    prefetch thread's start) and the warm-up of the first epoch."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    metrics = f"{tmp}/metrics_{'fused' if fused else 'plain'}.jsonl"
    state = train(train_config(fused), RunOptions(
        output=f"{tmp}/ckpt", dummy_data=True, epochs=2, steps_per_epoch=TRAIN_STEPS // 2, seed=0,
        metrics=metrics))
    torch.cuda.synchronize()
    records = [json.loads(line) for line in open(metrics)]
    losses = [r["loss"] for r in records]
    if state.step != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training ran {state.step} steps, logged losses {losses}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after training (a step's loss was not finite)")
    second = [r for r in records if r["epoch"] == 1]
    steps = [b["step"] - a["step"] for a, b in zip(second, second[1:])]
    seconds = [n / r["steps_per_sec"] for n, r in zip(steps, second[1:])]
    if sum(steps) < 2 * TRAIN_LOG_EVERY:
        raise AssertionError(f"too few timed steps: {steps}")
    return 1e3 * sum(seconds) / sum(steps), losses


def training_path_phase():
    import tempfile

    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import FusedDecoderLayer
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import FusedEncoderStack

    with tempfile.TemporaryDirectory() as tmp:
        for c in (FusedEncoderStack, FusedDecoderLayer):
            c.fwd_launches = c.bwd_launches = 0
        ms_fused, losses = timed_training(True, tmp)
        launches = {"fused_encoder_stack_fwd": FusedEncoderStack.fwd_launches,
                    "fused_encoder_stack_bwd": FusedEncoderStack.bwd_launches,
                    "fused_decoder_layer_fwd": FusedDecoderLayer.fwd_launches,
                    "fused_decoder_layer_bwd": FusedDecoderLayer.bwd_launches}
        log(f"training main path (train.py loop, synthetic data, bf16, B={TRAIN_BATCH}, "
            f"{TRAIN_STEPS} steps, fused knobs on): {ms_fused:.3f} ms/step, "
            f"{TRAIN_BATCH * 1e3 / ms_fused:.1f} samples/s; logged losses {losses}; launches {launches}")
        want = {"fused_encoder_stack_fwd": 3, "fused_encoder_stack_bwd": 3,
                "fused_decoder_layer_fwd": 4, "fused_decoder_layer_bwd": 4}
        for name, per_step in want.items():
            if launches[name] != per_step * TRAIN_STEPS:
                raise AssertionError(f"{name}: {launches[name]} launches on the training path, "
                                     f"expected {per_step} per step")
        ms_plain, _ = timed_training(False, tmp)
        log(f"unfused training step (knobs off, bf16 cuBLAS + torch ops), same loop: "
            f"{ms_plain:.3f} ms/step, {TRAIN_BATCH * 1e3 / ms_plain:.1f} samples/s")
    return launches, {"fused": ms_fused, "unfused": ms_plain}


def training_reference_phase(device):
    """3 steps of the kernel path on the card against the same 3 steps of the
    plain versions on the CPU, from the same init, batches, t and noise."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    cfg = train_config(True).model
    b, rng = 8, np.random.default_rng(11)
    base = DiffusionPolicy(cfg)
    base = load_jax_params(base, flax_init_params(base, 3))
    runs = {}
    for dev in (device, "cpu"):
        model = copy.deepcopy(base).to(dev)
        opt = make_optimizer(model, 1e-3, 10, grad_clip_norm=1.0)
        runs[dev] = (model, create_train_state(model, opt),
                     make_train_step(model, make_schedule(1000), opt, Normalizer.identity(20)), [])
    for _ in range(3):
        batch = random_batch(cfg, b, "cpu", rng)
        batch["joint_command"] = torch.from_numpy(rng.uniform(0, 2 * np.pi, (b, 10, 20)).astype(np.float32))
        t = torch.from_numpy(rng.integers(0, 1000, (b,)))
        noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32))
        for dev, (model, state, step, losses) in runs.items():
            on = lambda x: x.to(dev)
            metrics = step.apply(state, {k: on(v) for k, v in batch.items()}, on(t), on(noise))
            losses.append(metrics["loss"].item())
    (gm, _, _, gl), (cm, _, _, cl) = runs[device], runs["cpu"]
    ok = True
    for i, (lg, lc) in enumerate(zip(gl, cl)):
        rel = abs(lg - lc) / abs(lc)
        ok &= rel <= STEP_LOSS_TOL
        log(f"training step {i}: loss on {device} (kernels) {lg:.6f}, on cpu (plain versions) "
            f"{lc:.6f}, relative difference {rel:.3e} (tol {STEP_LOSS_TOL})")
    p0 = dict(base.named_parameters())
    num = den = max_diff = scale = 0.0
    for (name, pg), pc in zip(gm.named_parameters(), cm.parameters()):
        pg, pc = pg.detach().cpu(), pc.detach()
        num += ((pg - pc) ** 2).sum().item()
        den += ((pc - p0[name].detach()) ** 2).sum().item()
        max_diff, scale = max(max_diff, (pg - pc).abs().max().item()), max(scale, pc.abs().max().item())
    upd = (num / den) ** 0.5
    ok &= upd <= STEP_UPDATE_TOL
    log(f"after 3 steps: |params(card) - params(cpu)| / |update(cpu)| = {upd:.3e} "
        f"(tol {STEP_UPDATE_TOL}); max |param difference| / max|param| = {max_diff / scale:.3e}")
    if not ok:
        raise AssertionError("the kernel training path disagrees with the plain path")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def profile_training(fused: bool, out, steps=5, warm=5):
    """One torch.profiler trace of ``steps`` steps of training/train.py's step
    (the training main path's configuration and data, B=64) after ``warm``
    steps outside it. Wall and device busy time both come from this trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.data.pipeline import prefetch_to_device
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.train import build_dataset
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    config = train_config(fused)
    tc, device = config.train, torch.device("cuda")
    dataset = build_dataset(config, 0, True)
    normalizer = Normalizer.fit(dataset.sample_targets(tc.num_normalization_samples, seed=0))
    model = DiffusionPolicy(config.model)
    model = load_jax_params(model, flax_init_params(model, 0)).to(device)
    opt = make_optimizer(model, tc.lr, warm + steps, tc.weight_decay, grad_clip_norm=tc.grad_clip_norm)
    state = create_train_state(model, opt, ema=tc.ema_decay > 0.0)
    step = make_train_step(model, make_schedule(tc.train_denoising_timesteps), opt, normalizer,
                           ema_decay=tc.ema_decay)
    generator = torch.Generator(device=device).manual_seed(0)
    batches = prefetch_to_device(dataset.batches(tc.batch_size, shuffle=True, seed=0), device)
    try:
        for _ in range(warm):
            step(state, next(batches), generator)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, next(batches), generator)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        batches.close()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the trace holds no device ops: torch.profiler saw no device time")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3 / steps
    per_name: dict[str, list] = {}
    for e in dev:
        tot = per_name.setdefault(e.name, [0.0, 0])
        tot[0] += (e.time_range.end - e.time_range.start) / 1e3 / steps
        tot[1] += 1
    launch_ms = sum(e.self_cpu_time_total for e in prof.key_averages()
                    if e.key.startswith(("cudaLaunch", "cuLaunch"))) / 1e3 / steps
    name = "fused" if fused else "unfused"
    log(f"=== training step {name}, B={TRAIN_BATCH}, {steps} steps under torch.profiler: "
        f"wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
        f"({len(dev) / steps:.0f} device ops/step), device idle share {1 - busy_ms / wall_ms:.3f}, "
        f"host in kernel-launch calls {launch_ms:.3f} ms/step")
    for op, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:8.3f} ms/step {n / steps:6.1f}/step  {op[:110]}")
    if out:
        with open(out, "a") as f:
            f.write(f"=== {name}\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
            f.write("\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-training", action="store_true",
                        help="trace the training step with torch.profiler instead of the smoke run")
    parser.add_argument("--profile-out", default=None, help="file for the full profiler tables")
    args = parser.parse_args(argv)
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

    if args.profile_training:
        for fused in (True, False):
            profile_training(fused, args.profile_out)
        return 0
    cfg = bench_config()
    model = build_model(cfg, device)
    results = kernel_phase(cfg, model, device)
    launches, periods = main_path_phase(cfg, model, device)
    reference_phase(cfg, model, device)
    train_model = build_model(train_config(True).model, device, seed=2)
    results.update(training_kernel_phase(cfg, train_model, device))
    train_launches, step_ms = training_path_phase()
    training_reference_phase(device)

    replaces = {
        "fused_encoder": "soccerdiffusion_tpu/ops/fused_encoder.py:319",
        "fused_chunk": "soccerdiffusion_tpu/ops/fused_chunk.py:518",
        "fused_denoise": "soccerdiffusion_tpu/ops/fused_denoise.py:382",
        "fused_encoder_stack_fwd": "soccerdiffusion_tpu/ops/fused_encoder_stack.py:274",
        "fused_encoder_stack_bwd": "soccerdiffusion_tpu/ops/fused_encoder_stack.py:300",
        "fused_decoder_layer_fwd": "soccerdiffusion_tpu/ops/fused_decoder_layer.py:343",
        "fused_decoder_layer_bwd": "soccerdiffusion_tpu/ops/fused_decoder_layer.py:371",
    }
    counter = {"fused_encoder": "FusedContextEncoder", "fused_chunk": "FusedChunkSampler",
               "fused_denoise": "FusedDenoiser"}
    launches.update(train_launches)
    kernels = [{"name": name, "route": "cuda",
                "source": f"soccerdiffusion_tpu_torch/csrc/{name.removesuffix('_fwd').removesuffix('_bwd')}.cu",
                "replaces": replaces[name], "launches": launches[counter.get(name, name)],
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
               for name, (err, k_ms, p_ms) in results.items()]
    log(json.dumps({"kernels": kernels, "ms_per_replan_period": periods, "batch": BENCH_B,
                    "train_ms_per_step": step_ms, "train_batch": TRAIN_BATCH, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
