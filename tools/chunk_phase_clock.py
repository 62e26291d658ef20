"""Where the decoder pass of the chunk sampler's kernel, or of the
denoiser's, spends its time, phase by phase: builds an instrumented copy of
csrc/ (into build/chunk_phase_clock/) in which every statement of the
shared pass (csrc/decoder_pass.cuh: decoder_pass's body and its layer loop,
and the loops over the heads of both forms of chunk_cross_attention) and of
the chunk kernel's
step loop is followed by a block barrier and a timestamp (thread 0 of each
block adds the clock64 cycles since the previous one to that statement's
counter), and the kernel's prologue (the chunk's K/V projection, the
denoiser's staging of its parameters and step token) is timed as a whole.
Prints the cycles per block of each phase, per launch and labelled by the
statement, for the h128 head_dim-32 kernel over S=301, the flagship's
head_dim-64 kernel and larger_model's head_dim-128 kernel over S=311 (the
chunk: 30 DDIM steps) at B=64 (a robot on a 2-block cluster) or another
batch.

    python tools/chunk_phase_clock.py [--kernel chunk|denoise] [--batch B] [--h128-only]

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
# kernel -> (source file, its first line, the body statement the prologue ends before)
KERNELS = {
    "chunk": ("fused_chunk.cu", "fused_chunk_kernel(ChunkArgs a) {", "for (int t = 0;"),
    "denoise": ("fused_denoise.cu", "fused_denoise_kernel(DenoiseArgs a) {", "decoder_pass<"),
}
PASS = "decoder_pass.cuh"


def mark_statements(src: str, signature: str, labels: dict, prefix: str = "",
                    loops: tuple = (), body: bool = False, prologue: str | None = None) -> str:
    """``src`` with a barrier and a marker after every statement directly
    inside the function whose declaration starts on the line holding
    ``signature``: in its body if ``body``, and in each loop whose header
    starts with one of ``loops``. With ``prologue``, the clock starts at the
    function's entry and a marker before the body statement starting with
    it times everything before. Adds marker id -> ``prefix`` + the first
    line of the statement to ``labels``."""
    out, scopes, inside, depth, starts, stmt, closed = [], [], False, 0, True, "", ""

    def marker(label) -> str:
        labels[len(labels)] = prefix + label
        return f"__syncthreads(); PT({len(labels) - 1});"

    for line in src.split("\n"):
        if not inside and signature in line:
            inside, depth, scopes, starts = True, 0, [], True
        code = line.split("//")[0].strip()
        if not inside or not code or code.startswith("#"):
            out.append(line)
            continue
        at, net = depth, code.count("{") - code.count("}")
        if at >= 1 and starts and not code.startswith("}"):
            stmt = code[:90]
            if prologue and at == 1 and code.startswith(prologue):
                out.append("  " + marker("prologue"))
        for _ in range(net):  # a scope's statements are timed, and its header
            scopes.append((body if at == 0 else code.startswith(loops), stmt))
        for _ in range(-net):
            closed = scopes.pop()[1]
        depth = at + net
        label = stmt if code.endswith(";") and net == 0 else closed if code == "}" else None
        if at == 0 and net > 0 and prologue:
            line += "\n  PT_BEGIN();"
        timed = label is not None and depth >= 1 and scopes[depth - 1][0]
        out.append(line + (" " + marker(label) if timed else ""))
        starts = code.endswith((";", "{", "}"))
        if at > 0 and depth == 0:
            inside = False
    return "\n".join(out)


def instrument(kernel: str):
    """An instrument(sources) for the phase clock of ``kernel``."""
    file_name, first, prologue = KERNELS[kernel]

    def run(sources: dict) -> dict:
        labels: dict = {}
        sources[file_name] = mark_statements(sources[file_name], first, labels,
                                             loops=("for (int t = 0;",), prologue=prologue)
        text = mark_statements(sources[PASS], "__device__ __forceinline__ void decoder_pass(",
                               labels, loops=("for (int l = 0;",), body=True)
        sources[PASS] = mark_statements(text, "__device__ void chunk_cross_attention(", labels,
                                        prefix="cross: ",
                                        loops=("for (int h0 = 0;", "for (int h = 0;"))
        return labels

    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=tuple(KERNELS), default="chunk",
                        help="the whole-chunk sampler (default) or the denoiser")
    parser.add_argument("--batch", type=int, default=64, help="robots (default 64)")
    parser.add_argument("--h128-only", action="store_true",
                        help="skip the flagship's and larger_model's kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chunk_phase_clock: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler

    lib, labels = _phase_clock.build(OUT, KERNELS[args.kernel][0], instrument(args.kernel))
    _build.library = lambda: lib  # the wrapper launches the instrumented kernel
    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    steps = torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64), device="cuda")
    B = args.batch
    configs = [(cs.bench_config(), 301, 1), (cs.flagship_config(), 311, 3),
               (cs.larger_config(), 311, 5)]
    for cfg, S, seed in configs[:1] if args.h128_only else configs:
        model = cs.build_model(cfg, "cuda", seed=seed)
        chunk = FusedChunkSampler(model)
        with torch.no_grad():
            stk, stv = chunk.step_tables(model.step_encoding(steps)[:, 0])
            rng = np.random.default_rng(S)
            context = torch.from_numpy(rng.normal(size=(B, S, cfg.hidden_dim)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            noise = torch.from_numpy(rng.normal(size=(B, 10, 20)).astype(np.float32)).cuda()
            if args.kernel == "chunk":
                run = lambda: chunk.sample_kernel(context, noise, stk, stv, coefs)
            else:
                packed = chunk.pack_context_kv(model.precompute_context_kv(context))
                run = lambda: chunk.run_kernel(packed, noise, stk[3], stv[3])
            blocks = chunk.cluster_size(B, "cuda")
            cycles = _phase_clock.cycles_per_block(lib, run, B * blocks)
        print(f"== {args.kernel} E={cfg.hidden_dim} S={S} B={B} ({blocks} blocks a robot"
              f"{', 30 steps' if args.kernel == 'chunk' else ''}): {cycles.sum():.0f} cycles per "
              "block", flush=True)
        for i in np.nonzero(cycles)[0]:
            print(f"  {cycles[i]:11.0f}  {labels[int(i)]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
