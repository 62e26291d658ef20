"""Bit-level fingerprints of the encoder-layer kernels (the fused ViT block
and the fused encoder stack, forward and backward) on fixed seeded inputs.

Their device code (``csrc/encoder_layer.cuh`` over ``csrc/mma.cuh``) is
shared with the decoder layer and flash attention; a change to the shared
attention tiles must leave these kernels' outputs bit for bit as they were.
``tests/test_torch_cuda.py::test_layer_kernels_bit_identical_to_record``
holds them to ``tests/data/layer_kernels_golden.json``, which this script
wrote on an NVIDIA H100 from the kernels before the attention tiles took
separate q and k / v operands:

    python tests/cuda_golden.py OUT.json

(with ``PYTHONPATH`` at another checkout to fingerprint its kernels). Needs
the card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

# (label, op, width, heads, gelu, tokens, frames or robots)
CASES = [
    ("vit_hd64_quick", "vit", 256, 4, "quick", 64, 5),
    ("vit_hd32_exact", "vit", 128, 4, "exact", 49, 3),
    ("stack_hd32", "stack", 128, 4, None, 100, 3),
    ("stack_hd64", "stack", 128, 2, None, 10, 5),
]


def _weights(W, FF, L, seed):
    rng = np.random.default_rng(seed)
    shapes = [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,), (W,), (W,), (W, FF), (FF,),
              (FF, W), (W,)]
    w = []
    for i, s in enumerate(shapes):
        shape = s if L is None else (L, *s)
        a = rng.normal(size=shape) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=shape)
        w.append(torch.from_numpy((a + (1.0 if i in (0, 6) else 0.0)).astype(np.float32)))
    return w


def _digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]
    return hashlib.sha256(t.view(as_int).cpu().numpy().tobytes()).hexdigest()


def fingerprints(device="cuda") -> dict:
    """label -> {output name: sha256 of its bytes} for every case."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    out = {}
    for label, op, W, H, gelu, T, n in CASES:
        w = [t.to(device, torch.bfloat16)
             for t in _weights(W, 4 * W if op == "vit" else W, None if op == "vit" else 2, T)]
        rng = np.random.default_rng(T + n)
        x, dy = (torch.from_numpy(rng.normal(size=(n, T, W)).astype(np.float32)).to(
            device, torch.bfloat16) for _ in range(2))
        if op == "vit":
            y = fvb.forward_kernel(x, w, H, gelu)
            dx, grads = fvb.backward_kernel(x, dy, w, H, gelu)
        else:
            y, acts = fes.forward_kernel(x, w, H)
            dx, grads = fes.backward_kernel(acts, dy, w, H)
        torch.cuda.synchronize()
        out[label] = {"y": _digest(y), "dx": _digest(dx),
                      **{f"d{name}": _digest(g) for name, g in zip(fes.STACK_WEIGHTS, grads)}}
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python tests/cuda_golden.py OUT.json (on a machine with an NVIDIA GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"gpu": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "cuda": torch.version.cuda, "fingerprints": fingerprints()}
    with open(sys.argv[1], "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print(json.dumps(record["fingerprints"], sort_keys=True))
