"""Where the chunk sampler's kernel spends its time, phase by phase: builds
an instrumented copy of csrc/ (into build/chunk_phase_clock/) in which every
statement of fused_chunk_kernel's step loop and layer loop, and every
statement of its cross-attention's loop over the heads (chunk_cross_attention), is
followed by a block barrier and a timestamp (thread 0 of each block adds the
clock64 cycles since the previous one to that statement's counter), and the
once-per-chunk prologue is timed as a whole. Prints the cycles per block of
each phase, per chunk and labelled by the statement, for the h128 head_dim-32
sampler over S=301 and the flagship's head_dim-64 sampler over S=311, 30
DDIM steps at B=64 (one block per SM) or another batch.

    python tools/chunk_phase_clock.py [--batch B] [--h128-only]

Needs an NVIDIA GPU and nvcc. The instrumentation adds a barrier and an
atomic add per statement; compare phases with each other, not the total
with the kernel's time.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from soccerdiffusion_tpu_torch.ops import _build  # noqa: E402
from tools import _phase_clock  # noqa: E402

OUT = ROOT / "build" / "chunk_phase_clock"
KERNEL = "fused_chunk_kernel(ChunkArgs a) {"
CROSS = "__device__ void chunk_cross_attention("


def top(line: str) -> bool:
    """A line directly inside the cross-attention's loop over the heads."""
    return line.startswith("    ") and not line.startswith("     ")
LOOPS = ("for (int t = 0;", "for (int l = 0;")


def instrument(src: str) -> tuple[str, dict]:
    """The source with a barrier and a marker after every statement directly
    inside the kernel's step and layer loops, and one before the step loop;
    marker id -> the first line of the statement before it."""
    labels, out = {}, []
    stack, stmt, starts, inside = [], "", True, False

    def marker(label) -> str:
        labels[len(labels)] = label
        return f" __syncthreads(); PT({len(labels) - 1});"

    in_cross = False
    for line in src.split("\n"):
        stripped = line.strip()
        if line.startswith(CROSS):
            in_cross, stmt, starts = True, "", False
        if in_cross:
            if line == "}":
                in_cross = False
            elif starts and top(line) and not stripped.startswith(("//", "#", "}")):
                stmt = "cross: " + stripped[:80]
            if top(line) and stripped:
                starts = stripped.endswith((";", "{", "}"))
            ends = top(line) and (stripped.endswith(";") or stripped == "}")
            out.append(line + (marker(stmt) if in_cross and ends and stmt else ""))
            continue
        if KERNEL in line:
            inside, stack = True, []
            out.append(line + "\n  PT_BEGIN();")
            continue
        if not inside:
            out.append(line)
            continue
        if stripped.startswith(LOOPS[0]) and not stack:
            out.append("  __syncthreads();" + marker("once per chunk: K/V projection, carry").strip())
        if not stripped or stripped.startswith("//"):
            out.append(line)
            continue
        timed = bool(stack) and stack[-1]
        if starts and not stripped.startswith("}"):
            stmt = stripped[:90]
        starts = stripped.endswith((";", "{", "}"))
        if stripped.endswith("{"):
            stack.append(stripped.startswith(LOOPS))
            out.append(line)
            continue
        if stripped.startswith("}"):
            if not stack:
                inside = False
            else:
                stack.pop()
            out.append(line)
            continue
        out.append(line + (marker(stmt) if timed and stripped.endswith(";") else ""))
    return "\n".join(out), labels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=64, help="robots (default 64)")
    parser.add_argument("--h128-only", action="store_true", help="skip the flagship's sampler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chunk_phase_clock: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler

    lib, labels = _phase_clock.build(OUT, "fused_chunk.cu", instrument)
    _build.library = lambda: lib  # the wrapper launches the instrumented kernel
    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    steps = torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64), device="cuda")
    B = args.batch
    configs = [(cs.bench_config(), 301, 1), (cs.flagship_config(), 311, 3)]
    for cfg, S, seed in configs[:1] if args.h128_only else configs:
        model = cs.build_model(cfg, "cuda", seed=seed)
        chunk = FusedChunkSampler(model)
        with torch.no_grad():
            stk, stv = chunk.step_tables(model.step_encoding(steps)[:, 0])
            rng = np.random.default_rng(S)
            context = torch.from_numpy(rng.normal(size=(B, S, cfg.hidden_dim)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            noise = torch.from_numpy(rng.normal(size=(B, 10, 20)).astype(np.float32)).cuda()
            run = lambda: chunk.sample_kernel(context, noise, stk, stv, coefs)
            cycles = _phase_clock.cycles_per_block(lib, run, B * chunk.cluster_size(B, "cuda"))
        print(f"== chunk E={cfg.hidden_dim} S={S} B={B} ({chunk.cluster_size(B, 'cuda')} blocks a "
              f"robot), 30 steps: {cycles.sum():.0f} cycles per block", flush=True)
        for i in np.nonzero(cycles)[0]:
            print(f"  {cycles[i]:11.0f}  {labels[int(i)]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
