"""The fused ViT block's plain version (ops/fused_vit_block.py, the CPU
path) against the JAX kernel (soccerdiffusion_tpu/ops/fused_vit_block.py,
make_vit_block_fn in interpret mode), float32, exact and quick GELU, at
T=16 tokens (a sublane-tile multiple: the JAX rank-4 head stack) and T=9
(its concat path), W=64, 4 heads, FF=256, N=6 frames, both TPU layouts.
Inputs from numpy with a seed; weights with LayerNorm scales near 1 and
nonzero biases. Tolerance 2e-5 absolute: float32 summation order at
unit-scale activations (the JAX kernel's polynomial erf is within 1.5e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.ops.fused_vit_block import make_vit_block_fn
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder
from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb
from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import encoder_layer_weights

W, H, FF, N = 64, 4, 256, 6
ATOL = 2e-5


def weights(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,), (W,), (W,), (W, FF), (FF,), (FF, W),
              (W,)]
    out = []
    for i, s in enumerate(shapes):
        a = rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s)
        out.append((a + (1.0 if i in (0, 6) else 0.0)).astype(np.float32))  # LN scales ~1
    return out


@pytest.mark.parametrize("layout", ["stacked", "headloop"])
@pytest.mark.parametrize("T", [16, 9])
@pytest.mark.parametrize("gelu", ["exact", "quick"])
def test_plain_block_matches_jax_kernel(gelu, T, layout):
    w = weights()
    x = np.random.default_rng(1).standard_normal((N, T, W)).astype(np.float32)
    fn = make_vit_block_fn(H, block_frames=4, interpret=True, gelu=gelu, layout=layout)
    ref = np.asarray(fn(jnp.asarray(x), *[jnp.asarray(a) for a in w]))
    before = fvb.forward_kernel.launches
    got = fvb.vit_block(torch.from_numpy(x), [torch.from_numpy(a) for a in w], H, gelu)
    assert fvb.forward_kernel.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("gelu", ["exact", "quick"])
def test_fused_and_unfused_encoder_agree(gelu):
    """TransformerEncoder(fused_block=True) on the plain layers' parameters
    equals the unfused layers, which honour the GELU knob too."""
    torch.manual_seed(0)
    fused = TransformerEncoder(W, H, 2, ff_dim=FF, fused_block=True, fused_gelu=gelu)
    plain = TransformerEncoder(W, H, 2, ff_dim=FF, fused_gelu=gelu)
    with torch.no_grad():
        for p in fused.parameters():
            p.add_(0.1 * torch.randn_like(p))
        plain.load_state_dict(fused.state_dict())
        x = torch.randn(N, 16, W)
        torch.testing.assert_close(fused(x), plain(x), atol=ATOL, rtol=0)
        direct = fvb.forward_plain(x, encoder_layer_weights(fused.layers[0]), H, gelu)
        torch.testing.assert_close(direct, plain.layers[0](x), atol=ATOL, rtol=0)
    assert plain.layers[0].mlp.activation == ("quick_gelu" if gelu == "quick" else "gelu")


@pytest.mark.parametrize("kind", ["fused_block", "fused_stack"])
def test_serving_weights_are_packed_once(kind):
    """Without grad the fused encoder ops reuse one packed copy of the
    weights in the compute dtype until a parameter changes in place; with
    grad they take the float32 masters, so the parameters get gradients."""
    torch.manual_seed(1)
    enc = TransformerEncoder(W, H, 2, ff_dim=FF, **{kind: True}).to(torch.bfloat16).float()
    plain = TransformerEncoder(W, H, 2, ff_dim=FF)
    owner = enc.layers[0] if kind == "fused_block" else enc
    x = torch.randn(N, 9, W).to(torch.bfloat16)
    with torch.no_grad():
        y0 = enc(x)
        first = owner._packed[1]
        assert all(t.dtype == torch.bfloat16 for t in first)
        torch.testing.assert_close(enc(x), y0, atol=0, rtol=0)
        assert owner._packed[1] is first  # reused, not packed again
        enc.layers[0].mlp.linear2.bias.add_(1.0)  # an in-place update (an optimizer step)
        y1 = enc(x)
        assert owner._packed[1] is not first
        plain.load_state_dict(enc.state_dict())
        torch.testing.assert_close(y1.float(), plain(x.float()), atol=0.1, rtol=0.05)
    assert (y1.float() - y0.float()).abs().min() > 0.5  # the update reached the output
    enc(x.float()).sum().backward()
    assert enc.layers[0].mlp.linear2.bias.grad is not None


def test_unported_gelus_raise():
    w = [torch.from_numpy(a) for a in weights()]
    x = torch.zeros(2, 9, W)
    for gelu in ("poly", "bf16"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fvb.vit_block(x, w, H, gelu)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TransformerEncoder(W, H, 1, fused_block=True, fused_gelu=gelu)
    with pytest.raises(ValueError, match="exact GELU"):
        TransformerEncoder(W, H, 1, fused_stack=True, fused_gelu="quick")


def test_kernel_wrapper_checks_before_launch():
    """The kernel wrapper rejects what the CUDA kernel does not take before
    it builds or launches anything (so on CPU tensors too)."""
    w = [torch.from_numpy(a).to(torch.bfloat16) for a in weights()]
    x = torch.zeros(2, 9, W, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32 or 64"):
        fvb.forward_kernel(x, w, 8)  # head_dim 8
    with pytest.raises(ValueError, match="bfloat16"):
        fvb.forward_kernel(x.float(), w, H)
    assert fvb.smem_bytes(64, 256) == 198656  # the flagship frame: 194 KB of 227 KB
    shapes = [(256,), (256,), (256, 768), (768,), (256, 256), (256,), (256,), (256,), (256, 1024),
              (1024,), (1024, 256), (256,)]
    with pytest.raises(ValueError, match="shared memory"):  # 128 tokens x 256
        fvb.forward_kernel(torch.zeros(2, 128, 256, dtype=torch.bfloat16),
                           [torch.zeros(s, dtype=torch.bfloat16) for s in shapes], 4)
