"""Device time of the kernels, read from torch.profiler, beside the
CUDA-event time of the wrapper call (which adds the host's launch work):
the serving kernels at chip_smoke.py's main-path shapes (the context
encoder at h128 B=64 and 1024; the 30-step DDIM chunk sampler and the
denoiser, beside the denoiser's context K/V pack, at h128 over S=301 at
B=64 and 1024, at head_dim 64 (vit_flagship's decoder) over S=311 at B=64
and 256 and, in a tree that has them, at head_dim 128 (larger_model.yaml's
decoder) over S=311 at B=64), the decoder layer (forward and backward,
head_dim 64 at E=256 over S=312 memory rows and head_dim 32 at E=128 over
S=302, T=10, B=64 and 256) and flash attention at four of chip_smoke.py's
bf16 shapes.

    python tools/kernel_device_times.py [--only serving|training] [--tree DIR]
        [--chunk-threads auto,512,256] [--chunk-clusters auto,1,2]

(the launch shapes given apply to the chunk sampler and the denoiser alike).

``--tree`` imports the port from another checkout (a `git archive` of a
parent commit, say), so that two trees' kernels are timed by one script.
Needs an NVIDIA GPU; builds the kernels like chip_smoke.py. Seeded random
weights and operands; prints per call the wrapper's event time, the device
ops' total and the largest device ops.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
CALLS = 10


def decoder_weights(E, FF, seed=5):
    """The 22 bf16 weights in WEIGHT_NAMES order (Dense ~ 1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    shapes = [(E,), (E,), (E, 3 * E), (3 * E,), (E, E), (E,), (E,), (E,), (E, E), (E,), (E, E),
              (E,), (E, E), (E,), (E, E), (E,), (E,), (E,), (E, FF), (FF,), (FF, E), (E,)]
    out = []
    for i, s in enumerate(shapes):
        a = rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s)
        a = a + (1.0 if i in (0, 6, 16) else 0.0)
        out.append(torch.from_numpy(a.astype(np.float32)).cuda().to(torch.bfloat16))
    return out


def report(label, fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.device_time_total / CALLS) for e in prof.key_averages()
                      if e.device_time_total > 0 and not e.key.startswith("aten::")),
                     key=lambda r: -r[1])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    print(f"{label}: wrapper {start.elapsed_time(end) / CALLS * 1e3:.1f} us/call (CUDA events), "
          f"device {sum(t for _, t in kernels):.1f} us/call", flush=True)
    for key, t in kernels[:4]:
        print(f"    {t:9.1f} us  {key[:100]}", flush=True)


def launch_shapes(op, threads_list, clusters_list):
    """Yield a label for each launch shape of ``op`` to time, with ``op``
    set to launch it: the wrapper's own choice, or the given block sizes
    and blocks a robot (a tree whose op has no such choice: its own)."""
    shapes = [(None, None)]
    if hasattr(op, "cluster_size"):
        shapes = [(t, c) for t in threads_list for c in clusters_list]
    for threads, clusters in shapes:
        vars(op).pop("block_threads", None)
        vars(op).pop("cluster_size", None)
        if threads is not None:
            op.block_threads = lambda batch, context_len, device, n=threads: n
        if clusters is not None:
            op.cluster_size = lambda batch, device, n=clusters: n
        yield (("" if threads is None else f" threads={threads}")
               + ("" if clusters is None else f" cluster={clusters}"))


def serving(chunk_threads, chunk_clusters):
    import chip_smoke as cs
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder

    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    steps = torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64), device="cuda")
    h128 = cs.build_model(cs.bench_config(), "cuda")
    enc = FusedContextEncoder(h128)
    with torch.no_grad():
        for B in (64, 1024):
            batch = cs.random_batch(h128.config, B, "cuda", np.random.default_rng(B))
            report(f"context encoder h128 B={B}", lambda: enc.encode_kernel(batch))
        flagship = cs.build_model(cs.flagship_config(), "cuda", seed=3)
        models = [(h128, "h128 (head_dim 32)", 301, (64, 1024)),
                  (flagship, "flagship (head_dim 64)", 311, (64, 256))]
        if hasattr(cs, "larger_model"):  # a tree with the head_dim-128 instances
            models.append((cs.larger_model("cuda"), "larger_model (head_dim 128)", 311, (64,)))
        for model, label, S, batches in models:
            chunk, den = FusedChunkSampler(model), FusedDenoiser(model)
            stk, stv = chunk.step_tables(model.step_encoding(steps)[:, 0])
            E = model.config.hidden_dim
            for B in batches:
                rng = np.random.default_rng(B + S)
                context = torch.from_numpy(rng.normal(size=(B, S, E)).astype(np.float32)).to(
                    "cuda", torch.bfloat16)
                noise = torch.from_numpy(rng.normal(size=(B, 10, 20)).astype(np.float32)).cuda()
                for shape in launch_shapes(chunk, chunk_threads, chunk_clusters):
                    report(f"chunk ddim30 {label} S={S} B={B}{shape}",
                           lambda: chunk.sample_kernel(context, noise, stk, stv, coefs))
                context_kv = model.precompute_context_kv(context)
                report(f"denoiser pack_context_kv {label} S={S} B={B}",
                       lambda: den.pack_context_kv(context_kv))
                packed = den.pack_context_kv(context_kv)
                for shape in launch_shapes(den, chunk_threads, chunk_clusters):
                    report(f"denoiser {label} S={S} B={B}{shape}",
                           lambda: den.run_kernel(packed, noise, stk[3], stv[3]))


def training():
    from soccerdiffusion_tpu_torch.ops import flash_attention as fa
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(torch.bfloat16)
    for E, H, S in ((256, 4, 312), (128, 4, 302)):
        w = decoder_weights(E, E)
        for B in (64, 256):
            x, mem, dy = t(B, 10, E), t(B, S, E), t(B, 10, E)
            report(f"decoder fwd E={E} S={S} B={B}", lambda: fdl.forward_kernel(x, mem, w, H))
            report(f"decoder bwd E={E} S={S} B={B}",
                   lambda: fdl.backward_kernel(x, mem, dy, w, H))
    for B, Tq, Tk, H, D in ((640, 64, 64, 4, 64), (64, 10, 312, 4, 64), (64, 100, 100, 4, 64),
                            (64, 10, 10, 4, 64)):
        q, k, v, do = t(B, Tq, H, D), t(B, Tk, H, D), t(B, Tk, H, D), t(B, Tq, H, D)
        o, lse = fa.forward_kernel(q, k, v)
        shape = f"(B={B}, Tq={Tq}, Tk={Tk}, H={H}, D={D})"
        report(f"flash fwd {shape}", lambda: fa.forward_kernel(q, k, v))
        report(f"flash bwd {shape}", lambda: fa.backward_kernel(q, k, v, o, lse, do))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=("serving", "training"), default=None)
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose port is timed")
    parser.add_argument("--chunk-threads", default="auto",
                        help="comma-separated block sizes of the chunk and denoiser kernels "
                             "to time (auto: the wrapper's choice)")
    parser.add_argument("--chunk-clusters", default="auto",
                        help="comma-separated blocks a robot (1 or 2) of the chunk and "
                             "denoiser kernels to time (auto: the wrapper's choice)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_device_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.tree).resolve()), str(ROOT)]
    print(f"port from {Path(args.tree).resolve()}", flush=True)
    if args.only in (None, "serving"):
        given = lambda arg: [None if t == "auto" else int(t) for t in arg.split(",")]
        serving(given(args.chunk_threads), given(args.chunk_clusters))
    if args.only in (None, "training"):
        training()
    return 0


if __name__ == "__main__":
    sys.exit(main())
