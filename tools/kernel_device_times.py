"""Device time of the decoder-layer and flash-attention kernels, read from
torch.profiler, beside the CUDA-event time of the wrapper call (which adds
the host's launch work): the decoder layer (forward and backward, head_dim
64 at E=256 over S=312 memory rows and head_dim 32 at E=128 over S=302, T=10,
B=64 and 256) and flash attention at four of chip_smoke.py's bf16 shapes.

    python tools/kernel_device_times.py

Needs an NVIDIA GPU; builds the kernels like chip_smoke.py. Seeded random
bf16 operands; prints per call the wrapper's event time, the device ops'
total and the largest device ops.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from soccerdiffusion_tpu_torch.ops import flash_attention as fa  # noqa: E402
from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl  # noqa: E402

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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_device_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
