"""What the phase clocks (tools/chunk_phase_clock.py,
tools/decoder_phase_clock.py) share: the cycle counters and timestamp
macros of an instrumented copy of csrc/, its build with the port's nvcc
flags and C entries, and a read of the counters per block.

A tool's instrument(sources) edits the copy's sources (file name -> text)
in place and returns the labels of its counters: ``PT_BEGIN();`` where a
clock starts and ``PT(id);`` after each phase, where thread 0 of each block
adds the clock64 cycles since the previous timestamp to counter id. The
counters live in one translation unit, the measured kernel's; in every
other one (which may include an instrumented header) the two macros do
nothing.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from soccerdiffusion_tpu_torch.ops import _build

COUNTERS = 256
PRELUDE = f"""
__device__ unsigned long long sd_phase_sum[{COUNTERS}];
extern "C" int sd_phase_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, sd_phase_sum, sizeof(sd_phase_sum));
}}
extern "C" int sd_phase_zero() {{
  static unsigned long long z[{COUNTERS}];
  return (int)cudaMemcpyToSymbol(sd_phase_sum, z, sizeof(z));
}}
__shared__ long long sd_t0;
#define PT_BEGIN() do {{ if (threadIdx.x == 0) sd_t0 = clock64(); }} while (0)
#define PT(id) do {{ if (threadIdx.x == 0) {{ const long long _t = clock64(); \\
  atomicAdd(&sd_phase_sum[id], (unsigned long long)(_t - sd_t0)); sd_t0 = _t; }} }} while (0)
"""
NO_CLOCK = "#define PT_BEGIN() do {} while (0)\n#define PT(id) do {} while (0)\n"


def one_file(name: str, instrument: Callable[[str], tuple[str, dict]]) -> Callable[[dict], dict]:
    """An instrument(sources) that edits the one source ``name`` with
    ``instrument(text) -> (text, labels)``."""
    def run(sources: dict) -> dict:
        sources[name], labels = instrument(sources[name])
        return labels
    return run


def build(out: Path, file_name: str,
          instrument: Callable[[dict], dict]) -> tuple[ctypes.CDLL, dict]:
    """Copy csrc/ into out, instrument its sources (the counters declared at
    the head of file_name, the macros no-ops in every other .cu file),
    compile every source in parallel and link them; returns the library,
    its C entries bound as _build binds them, and the instrumentation's
    labels."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    sources = {path.name: path.read_text() for path in (out / "csrc").iterdir()}
    labels = instrument(sources)
    for name, text in sources.items():
        if name.endswith(".cu"):
            text = (PRELUDE if name == file_name else NO_CLOCK) + text
        (out / "csrc" / name).write_text(text)
    srcs = sorted((out / "csrc").glob("*.cu"))
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(out / f"{s.stem}.o"),
                               str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s in srcs]
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                    str(out / "lib.so"), *[str(out / f"{s.stem}.o") for s in srcs]], check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for name, argtypes in _build._ENTRIES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, labels


def cycles_per_block(lib: ctypes.CDLL, run: Callable[[], object], blocks: int) -> np.ndarray:
    """Each counter's cycles per block over one call of run (after one
    call that compiles and warms up)."""
    run()
    torch.cuda.synchronize()
    lib.sd_phase_zero()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * COUNTERS)()
    lib.sd_phase_read(buf)
    return np.array(buf[:], dtype=np.float64) / blocks
