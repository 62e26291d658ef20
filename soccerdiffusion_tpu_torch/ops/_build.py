"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for sm_90a (one process per source,
all started together; ``build.log`` has each one's output and seconds) and
links the objects into one shared library with a plain C interface, loaded
with ``ctypes``. The library goes to
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, and is built at first use (so the first kernel call, or
``python3 chip_smoke.py``, builds everything from the checkout).

Every pointer and the stream pass as ``ctypes.c_void_p``; each C entry
returns ``cudaGetLastError()`` after its launch and ``check`` raises when
that is not 0. (``torch.utils.cpp_extension.load`` is not used: including
PyTorch's headers makes a build take minutes instead of seconds.)
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
# C entry -> argtypes (pointer array, int array[, float array], stream)
_ENTRIES = {
    "sd_fused_encoder": [ctypes.POINTER(_P), _I, _P],
    "sd_fused_denoise": [ctypes.POINTER(_P), _I, _F, _P],
    "sd_pack_context_kv": [ctypes.POINTER(_P), _I, _P],
    "sd_fused_chunk": [ctypes.POINTER(_P), _I, _P],
    "sd_fused_chunk_int8": [ctypes.POINTER(_P), _I, _P],
    "sd_encoder_stack_fwd": [ctypes.POINTER(_P), _I, _P],
    "sd_encoder_stack_bwd": [ctypes.POINTER(_P), _I, _P],
    "sd_decoder_layer_fwd": [ctypes.POINTER(_P), _I, _P],
    "sd_decoder_layer_bwd": [ctypes.POINTER(_P), _I, _P],
    "sd_vit_block_fwd": [ctypes.POINTER(_P), _I, _P],
    "sd_vit_block_bwd": [ctypes.POINTER(_P), _I, _P],
    "sd_vit_block_bwd_rows": [ctypes.POINTER(_P), _I, _P],
    "sd_flash_attention_fwd": [ctypes.POINTER(_P), _I, _P],
    "sd_flash_attention_bwd": [ctypes.POINTER(_P), _I, _P],
    "sd_pass_smem_bytes": [_I],
    "sd_int8_smem_bytes": [_I],
    "sd_vit_block_bwd_rows_partials": [_I],
}
# entries that return something other than a CUDA error code
_RESTYPES = {"sd_pass_smem_bytes": ctypes.c_longlong,
             "sd_int8_smem_bytes": ctypes.c_longlong,
             "sd_vit_block_bwd_rows_partials": ctypes.c_longlong}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, compiled on the first call of the process."""
    out = build_dir()
    so = out / "libsd_kernels.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        nvcc, tag, t0 = _nvcc(), os.getpid(), time.perf_counter()
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [out / f"{src.stem}.{tag}.o" for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
        tmp = out / f"libsd_kernels.{tag}.so"

        def compile_one(cmd):  # (cmd, output with its seconds, exit code)
            start = time.perf_counter()
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return cmd, proc.stdout + f"{time.perf_counter() - start:.1f} s\n", proc.returncode

        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            logs = list(pool.map(compile_one, cmds))
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                *map(str, objs)]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        (out / "build.log").write_text(
            "".join(f"$ {' '.join(cmd)}\n{text}exit {rc}\n" for cmd, text, rc in logs)
            + f"built in {time.perf_counter() - t0:.1f} s\n")
        failed = [(cmd, text, rc) for cmd, text, rc in logs if rc != 0]
        if failed:
            cmd, text, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text[-4000:]}")
        # several processes may build at once (ranks that share a card): each
        # writes its own pid-tagged objects and library and renames the
        # library into place atomically, so a loader sees a whole file (a
        # later rename swaps in an identical one; a process that has it
        # loaded keeps its mapping); build.log is whichever build wrote last
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def pointers(*tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (None -> NULL)."""
    return (_P * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def ints(*values: int) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def floats(*values: float) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
