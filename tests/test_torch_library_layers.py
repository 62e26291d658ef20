"""chip_smoke.py's torch.nn library layers (timed beside the kernels for the
``library_ms`` column) compute the same functions as the kernels' plain
versions when built from the same weights: float32, on the CPU, inputs and
weights from numpy with a seed. Tolerance 1e-4 absolute: float32 summation
order through fused-attention and GELU implementations at unit scale."""

import numpy as np
import pytest
import torch

import chip_smoke
from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

E, FF = 32, 64
ATOL = 1e-4


def random_weights(shapes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.normal(size=s) / np.sqrt(s[-2]) if len(s) >= 2 else 0.1 * rng.normal(size=s)
        out.append(torch.from_numpy(a.astype(np.float32)))
    return out


def stack_shapes(L, ff):
    return [(L, E), (L, E), (L, E, 3 * E), (L, 3 * E), (L, E, E), (L, E), (L, E), (L, E),
            (L, E, ff), (L, ff), (L, ff, E), (L, E)]


@pytest.mark.parametrize("L,H", [(2, 4), (1, 2)])
def test_torch_encoder_is_the_stack(L, H):
    w = random_weights(stack_shapes(L, FF), L)
    w[0] += 1.0  # LayerNorm scales near 1
    w[6] += 1.0
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(3, 9, E)).astype(np.float32))
    with torch.no_grad():
        got = chip_smoke.torch_encoder(w, H)(x)
    torch.testing.assert_close(got, fes.forward_plain(x, w, H), atol=ATOL, rtol=0)


@pytest.mark.parametrize("gelu", ["exact", "quick"])
def test_torch_encoder_layer_is_the_vit_block(gelu):
    w = random_weights(stack_shapes(1, 4 * E), 3)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(4, 16, E)).astype(np.float32))
    act = chip_smoke.quick_gelu if gelu == "quick" else "gelu"
    with torch.no_grad():
        got = chip_smoke.torch_encoder(w, 2, act)(x)
    torch.testing.assert_close(got, fvb.forward_plain(x, [t[0] for t in w], 2, gelu),
                               atol=ATOL, rtol=0)


def test_torch_decoder_layer_is_the_decoder_layer():
    shapes = ([(E,), (E,), (E, 3 * E), (3 * E,), (E, E), (E,), (E,), (E,)]
              + [(E, E), (E,)] * 4 + [(E,), (E,), (E, FF), (FF,), (FF, E), (E,)])
    w = random_weights(shapes, 4)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 10, E)).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(3, 21, E)).astype(np.float32))
    with torch.no_grad():
        got = chip_smoke.torch_decoder_layer(w, 4)(x, mem)
    torch.testing.assert_close(got, fdl.forward_plain(x, mem, w, 4), atol=ATOL, rtol=0)
