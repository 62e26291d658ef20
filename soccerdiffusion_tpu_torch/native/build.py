"""Build and load ``framepack.cpp`` (the port's copy of the JAX package's
``native/framepack.cpp``) with the host C++ compiler:

    g++ -O3 -shared -fPIC -std=c++17 -pthread framepack.cpp -o libframepack.so

into ``build/native/<hash>/`` at the repository root, keyed by a hash of the
source, the compiler and the flags, at the first call of a process. A
failed build raises with the compiler's output: there is no silent numpy
fallback (``PackedDataset(assembler="numpy")`` asks for the numpy assembler
explicitly). The compiler is ``g++``, or the one named by the ``compiler``
argument.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "framepack.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def build_dir(compiler: str = "g++") -> Path:
    digest = hashlib.sha256(" ".join([compiler, *CXX_FLAGS]).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_framepack(compiler: str = "g++") -> ctypes.CDLL:
    """The framepack library, compiled on the first call of the process
    (raises ``RuntimeError`` with the compiler's output if it does not build)."""
    out = build_dir(compiler)
    so = out / "libframepack.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libframepack.{os.getpid()}.so"
        cmd = [compiler, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"cannot run the C++ compiler {compiler!r} to build "
                               f"{SOURCE.name}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i64, f32p, i32p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64))
    lib.fp_assemble_batch.argtypes = [
        f32p, f32p, f32p, i32p,  # cmds, states, rots, game states
        i64, i64,  # num_joints, rot_dim
        i64p, i64p,  # rec_starts, local_idx
        i64, i64, i64, i64, i64,  # batch, future, hist, state, imu
        f32p,  # rot_pad
        f32p, f32p, f32p, f32p, i32p,  # outputs
        ctypes.c_int32,  # num_threads
    ]
    lib.fp_assemble_batch.restype = None
    lib.fp_forward_fill_gamestate.argtypes = [f32p, i32p, i64, ctypes.c_double, i64,
                                              ctypes.c_int32, i32p]
    lib.fp_forward_fill_gamestate.restype = None
    return lib
