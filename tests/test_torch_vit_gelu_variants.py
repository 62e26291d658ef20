"""The fused ViT block's "poly" and "bf16" GELUs (ops/_train_math.py, the
plain versions of csrc/train_common.cuh:Gelu) against the JAX package
(soccerdiffusion_tpu/ops/fused_vit_block.py).

  * the GELU functions on a grid of 200001 points over [-6, 6]: "poly" and
    its gradient in float32, the "bf16" chain (gate, output, dz) on bf16
    values, each bit for bit the JAX function's;
  * the block's forward and every gradient against jax.vjp of
    make_vit_block_fn(gelu=...) in interpret mode, float32, head_dim 32 and
    64: within TOL = 1e-4 of each tensor's scale (float32 summation order
    at unit-scale activations, as tests/test_torch_flagship_kernels.py);
  * the block in bfloat16, where the "bf16" chain rounds at every op:
    within BF16_TOL = 2e-2 of scale (both sides round to bf16 at the same
    points; the sums' order flips some roundings, 2^-8 of a value each, as
    the card's kernel-vs-plain bound in chip_smoke.py);
  * the unfused layers' mapping ("poly" to exact GELU, "bf16" to
    quick-GELU) against the JAX TransformerEncoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.models.transformer import TransformerEncoder as JaxEncoder
from soccerdiffusion_tpu.ops.fused_vit_block import (_gelu_poly, _gelu_poly_grad, _gelu_quick,
                                                     _gelu_quick_grad, make_vit_block_fn)
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder
from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb
from soccerdiffusion_tpu_torch.ops._train_math import (gelu_dz, gelu_gate, gelu_poly,
                                                       gelu_poly_grad, gelu_value, rnd)
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params
from tests.test_torch_flagship_kernels import TOL, assert_grads_close, layer_weights

BF16_TOL = 2e-2


def test_gelu_functions_bit_for_bit():
    z = np.linspace(-6, 6, 200001).astype(np.float32)
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    np.testing.assert_array_equal(gelu_poly(zt).numpy(), np.asarray(_gelu_poly(zj)))
    np.testing.assert_array_equal(gelu_poly_grad(zt).numpy(), np.asarray(_gelu_poly_grad(zj)))
    dhg = np.random.default_rng(0).standard_normal(z.shape).astype(np.float32)
    zb = zj.astype(jnp.bfloat16)
    s_j = _gelu_quick(zb)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    s_p = gelu_gate(zt, "bf16", torch.bfloat16)
    np.testing.assert_array_equal(s_p.numpy(), f32(s_j))
    np.testing.assert_array_equal(
        rnd(gelu_value(zt, s_p, "bf16", torch.bfloat16), torch.bfloat16).numpy(),
        f32((zb * s_j).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(
        gelu_dz(torch.from_numpy(dhg), zt, s_p, "bf16", torch.bfloat16).numpy(),
        f32(jnp.asarray(dhg).astype(jnp.bfloat16) * _gelu_quick_grad(zb, s_j)))


@pytest.mark.parametrize("gelu", ["poly", "bf16"])
@pytest.mark.parametrize("width,heads", [(64, 2), (128, 2)])  # head_dim 32, 64
def test_block_forward_and_gradients_match_jax_vjp(width, heads, gelu):
    rng = np.random.default_rng(width + len(gelu))
    n, t = 4, 16
    w = layer_weights(rng, width, 4 * width)
    x = rng.standard_normal((n, t, width)).astype(np.float32)
    dy = rng.standard_normal((n, t, width)).astype(np.float32)
    fn = make_vit_block_fn(heads, block_frames=2, interpret=True, gelu=gelu)
    y_j, vjp = jax.vjp(fn, jnp.asarray(x), *[jnp.asarray(a) for a in w])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tw = [torch.from_numpy(a) for a in w]
    before = (fvb.forward_kernel.launches, fvb.backward_kernel.launches)
    y_p = fvb.forward_plain(torch.from_numpy(x), tw, heads, gelu)
    dx, grads = fvb.backward_plain(torch.from_numpy(x), torch.from_numpy(dy), tw, heads, gelu)
    assert (fvb.forward_kernel.launches, fvb.backward_kernel.launches) == before
    assert_grads_close(["y", "dx", *fes.STACK_WEIGHTS], [y_p, dx, *grads],
                       [np.asarray(y_j), *want], {"bqkv": slice(width, 2 * width)})


@pytest.mark.parametrize("gelu", ["bf16", "poly"])
def test_block_in_bfloat16_matches_jax(gelu):
    """In bf16 the "bf16" GELU's chain rounds at every op on both sides."""
    rng = np.random.default_rng(5)
    width, heads, n, t = 64, 2, 4, 16
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    w = [bf(a) for a in layer_weights(rng, width, 4 * width)]
    x = bf(rng.standard_normal((n, t, width)))
    dy = bf(rng.standard_normal((n, t, width)))
    fn = make_vit_block_fn(heads, block_frames=2, interpret=True, gelu=gelu)
    y_j, vjp = jax.vjp(fn, x, *w)
    want = [np.asarray(y_j.astype(jnp.float32))] + [np.asarray(g.astype(jnp.float32))
                                                     for g in vjp(dy)]
    tb = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    tw = [tb(a) for a in w]
    y_p = fvb.forward_plain(tb(x), tw, heads, gelu)
    dx, grads = fvb.backward_plain(tb(x), tb(dy), tw, heads, gelu)
    top = max(np.abs(a).max() for a in want)
    for name, g, r in zip(["y", "dx", *fes.STACK_WEIGHTS], [y_p, dx, *grads], want):
        g = g.float().numpy().reshape(r.shape)
        bound = BF16_TOL * (top if name == "bqkv" else np.abs(r).max())
        assert np.abs(g - r).max() <= bound, (name, np.abs(g - r).max(), bound)


@pytest.mark.parametrize("gelu", ["poly", "bf16"])
def test_unfused_layers_follow_the_jax_mapping(gelu):
    """With the fused block off, "poly" runs exact GELU and "bf16"
    quick-GELU in both packages, on the same parameters."""
    width, heads, layers = 64, 4, 2
    x = np.random.default_rng(2).standard_normal((3, 9, width)).astype(np.float32)
    jenc = JaxEncoder(width, heads, layers, fused_gelu=gelu)
    variables = jenc.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    enc = load_jax_params(TransformerEncoder(width, heads, layers, fused_gelu=gelu),
                          jax.tree.map(np.asarray, variables["params"]), {})
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max(), rtol=0)
