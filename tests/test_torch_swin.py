"""The port's Swin encoder (models/swin.py) against the JAX package's
(soccerdiffusion_tpu/models/swin.py), float32: the window helpers, the
relative position index and the shifted-window mask equal JAX's; a
SwinBlock (unshifted and shifted) and PatchMerging at small width, forward
and every gradient against jax.grad; one full swin_transformer_tiny forward
at 224 px on one frame (its last stage, 7x7, attends in one unshifted
window).

Params come from random_jax_params (the flax layout, seeded) or flax's
init, inputs from numpy with a seed. Tolerance: 1e-4 of each tensor's
largest magnitude (float32 summation order; LayerNorm and GELU are smooth,
so float32 differences stay at rounding level), 2e-4 through the 12
blocks of the full encoder.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.models import swin as jswin
from soccerdiffusion_tpu_torch.models import swin
from soccerdiffusion_tpu_torch.models.vision import make_image_encoder
from soccerdiffusion_tpu_torch.utils.jax_params import _flatten, load_jax_params, random_jax_params

TOL, FULL_TOL = 1e-4, 2e-4


def close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0, err_msg=what)


@pytest.mark.parametrize("window,side", [(7, 14), (7, 56), (4, 8)])
def test_window_partition_round_trip_matches_jax(window, side):
    x = np.random.default_rng(side).standard_normal((2, side, side, 5)).astype(np.float32)
    got = swin.window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x),
                                                                                  window)))
    back = swin.window_unpartition(got, window, side, side)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("window", [2, 3, 7])
def test_relative_position_index_matches_jax(window):
    np.testing.assert_array_equal(swin.relative_position_index(window),
                                  jswin.relative_position_index(window))


@pytest.mark.parametrize("side,window,shift", [(14, 7, 3), (56, 7, 3), (8, 4, 2)])
def test_shift_mask_matches_jax(side, window, shift):
    np.testing.assert_array_equal(swin.shift_attn_mask(side, side, window, shift),
                                  jswin.shift_attn_mask(side, side, window, shift))


def grads_of(module, x, dy):
    """Output, input gradient and {param: grad} of sum(module(x) * dy)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt)
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach(), xt.grad, {n: p.grad for n, p in module.named_parameters()}


def check_against_jax(jmodule, module, x, dy):
    params = jax.tree.map(np.asarray, jmodule.init(jax.random.key(0), jnp.asarray(x))["params"])
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    load_jax_params(module, params)
    ref = jmodule.apply({"params": params}, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jmodule.apply({"params": p}, xx) * dy),
                      argnums=(0, 1))(params, jnp.asarray(x))
    out, dx, grads = grads_of(module, x, dy)
    close(out.numpy(), ref, what="output")
    close(dx.numpy(), gx, what="dx")
    want = {n: p.detach().numpy() for n, p in load_jax_params(
        copy.deepcopy(module), jax.tree.map(np.asarray, gp)).named_parameters()}
    assert len(grads) == len(_flatten(gp))
    for name, g in grads.items():
        close(g.numpy(), want[name], what=name)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_matches_jax(shift):
    dim, heads, window, side = 32, 2, 7, 14
    rng = np.random.default_rng(shift)
    x = rng.standard_normal((2, side, side, dim)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    check_against_jax(jswin.SwinBlock(dim, heads, window, shift),
                      swin.SwinBlock(dim, heads, window, shift, side), x, dy)


def test_patch_merging_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 14, 14, 24)).astype(np.float32)
    dy = rng.standard_normal((2, 7, 7, 48)).astype(np.float32)
    check_against_jax(jswin.PatchMerging(24), swin.PatchMerging(24), x, dy)


def test_swin_tiny_forward_at_224_matches_jax():
    enc = make_image_encoder("swin_transformer_tiny", 32, 224)
    params, stats = random_jax_params(enc, seed=6)
    assert stats == {}
    load_jax_params(enc, params)
    x = np.random.default_rng(6).standard_normal((1, 224, 224, 3)).astype(np.float32)
    # eagerly: the JAX block builds its shift mask with numpy, which a jit trace refuses
    ref = jswin.SwinImageEncoder(32, "tiny").apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    close(got.numpy(), ref, FULL_TOL)
    last = enc.stage3_block1
    assert (last.window, last.shift) == (7, 0) and enc.stage0_block1.shift == 3
