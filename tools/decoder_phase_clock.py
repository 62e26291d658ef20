"""Where the decoder-layer kernels spend their time, phase by phase: builds
an instrumented copy of csrc/ (into build/decoder_phase_clock/) in which
every block barrier of the forward kernel, the backward's recompute and the
backward (csrc/fused_decoder_layer.cu: dec_fwd_smem, dec_fwd_ws, dec_bwd),
and a few added ones, are followed by a timestamp: thread 0 of each block
adds the clock64 cycles since the previous one to that barrier's counter.
Prints the cycles per block of each phase, labelled by the statement before
its barrier, for the flagship's head_dim-64 layer (E=256, S=312) and the
h128 head_dim-32 layer (E=128, S=302) at T=10, B=64 (one block per SM).

    python tools/decoder_phase_clock.py

Needs an NVIDIA GPU and nvcc. The instrumentation adds a barrier and an
atomic add per phase; compare phases with each other, not the total with
the kernel's time.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from soccerdiffusion_tpu_torch.ops import _build  # noqa: E402
from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl  # noqa: E402
from tools import _phase_clock  # noqa: E402
from tools.kernel_device_times import decoder_weights  # noqa: E402

OUT = ROOT / "build" / "decoder_phase_clock"
# calls whose own barriers are inside them: a marker after each
AFTER = ("attn_fwd_split<D>(", "attention_bwd_dq<D>(", "attention_bwd_dkv<D, true, true>(",
         "mma_dense_rows<2, 4>(sm,", "attention_bwd<D>(s.qkv")


def instrument(src: str) -> tuple[str, dict]:
    """The source with a marker after every barrier of the three functions
    and after each AFTER call; marker id -> (function, the first line of the
    statement before it)."""
    labels, out = {}, []
    fn, stmt, starts, pending = None, "", True, False

    def marker() -> str:
        labels[len(labels)] = (fn, stmt)
        return f"PT({len(labels) - 1});"

    for line in src.split("\n"):
        stripped = line.strip()
        m = re.match(r"__device__ void (dec_fwd_smem|dec_fwd_ws|dec_bwd)\(", line)
        if m:
            fn, starts = m.group(1), True
        elif fn and line == "}":
            fn = None
        if fn and stripped == "__syncthreads();":
            out.append(f"{line} {marker()}")
            continue
        out.append(line)
        if not fn or not stripped or stripped.startswith(("//", "#")):
            continue
        if starts:
            stmt = stripped[:90]
            pending = stripped.startswith(AFTER)
        starts = stripped.endswith((";", "{", "}"))
        if pending and stripped.endswith(";"):
            pending = False
            out.append(f"  __syncthreads(); {marker()}")
    text = "\n".join(out)
    for name in ("dec_fwd_smem", "dec_fwd_ws", "dec_bwd"):  # each clock starts at entry
        head = re.search(rf"__device__ void {name}\([^{{]*\{{", text)
        text = text[:head.end()] + "\n  PT_BEGIN();" + text[head.end():]
    return text, labels


def main() -> int:
    if not torch.cuda.is_available():
        print("decoder_phase_clock: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lib, labels = _phase_clock.build(OUT, "fused_decoder_layer.cu",
                                     _phase_clock.one_file("fused_decoder_layer.cu", instrument))
    _build.library = lambda: lib  # the wrappers launch the instrumented kernels
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(torch.bfloat16)
    B = 64
    for E, H, S in ((256, 4, 312), (128, 4, 302)):
        w = decoder_weights(E, E)
        x, mem, dy = t(B, 10, E), t(B, S, E), t(B, 10, E)
        for label, fn in (("forward", lambda: fdl.forward_kernel(x, mem, w, H)),
                          ("backward", lambda: fdl.backward_kernel(x, mem, dy, w, H))):
            cycles = _phase_clock.cycles_per_block(lib, fn, B)
            print(f"== decoder {label} E={E} S={S} T=10 B={B}: {cycles.sum():.0f} cycles per block",
                  flush=True)
            for i in np.nonzero(cycles)[0]:
                fn_name, stmt = labels[int(i)]
                print(f"  {cycles[i]:9.0f}  {fn_name}: {stmt}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
