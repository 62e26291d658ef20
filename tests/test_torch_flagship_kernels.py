"""The plain versions of the flagship training step's kernels against the
JAX kernels (interpret mode, float32), at small sizes:

  * the fused ViT block's backward (ops/fused_vit_block.py:backward_plain)
    against jax.vjp of make_vit_block_fn at head_dim 32 and 64, exact and
    quick GELU (N=4 frames of T=16 tokens, FF=4W);
  * the encoder-stack backward at head_dim 64 (2 heads x 64, L=2, T=10) and
    the image-frame stack's shape (8 heads x 32, T=10, L=1);
  * the decoder layer's forward and backward at head_dim 64 (2 heads x 64,
    T=10, S=19).

Tolerance: max |port - JAX| <= 1e-4 x max |JAX| of each tensor (float32
summation order through the products and the JAX kernel's polynomial erf,
<= 1.5e-7); the key bias's gradient, zero in exact arithmetic, against the
largest weight gradient of the layer instead of its own scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.ops.fused_decoder_layer import make_decoder_layer_fn
from soccerdiffusion_tpu.ops.fused_encoder_stack import make_encoder_stack_fn
from soccerdiffusion_tpu.ops.fused_vit_block import make_vit_block_fn
from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

TOL = 1e-4


def layer_weights(rng, e, ff, lead=()):
    """Encoder-layer weights in STACK_WEIGHTS order with a leading ``lead``
    shape: LayerNorm scales near 1, nonzero biases, LeCun-scaled kernels."""
    shapes = [(e,), (e,), (e, 3 * e), (3 * e,), (e, e), (e,), (e,), (e,), (e, ff), (ff,), (ff, e),
              (e,)]
    out = []
    for i, s in enumerate(shapes):
        a = rng.normal(size=lead + s)
        a = a / np.sqrt(s[0]) if len(s) == 2 else 0.1 * a
        out.append((a + (1.0 if i in (0, 6) else 0.0)).astype(np.float32))
    return out


def assert_grads_close(names, got, want, zero):
    """Every tensor within TOL x its scale; ``zero`` maps a name to the
    last-axis slice that vanishes in exact arithmetic."""
    top = max(np.abs(w).max() for w in want)
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32).reshape(g.shape)
        if name in zero:
            cut = zero[name]
            assert np.abs(g[..., cut] - w[..., cut]).max() <= TOL * top, name
            keep = np.ones(g.shape[-1], bool)
            keep[cut] = False
            g, w = g[..., keep], w[..., keep]
            if not g.size:
                continue
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), (name, np.abs(g - w).max())


@pytest.mark.parametrize("gelu", ["exact", "quick"])
@pytest.mark.parametrize("width,heads", [(64, 2), (128, 2)])  # head_dim 32, 64
def test_vit_block_backward_matches_jax_vjp(width, heads, gelu):
    rng = np.random.default_rng(width + len(gelu))
    n, t = 4, 16
    w = layer_weights(rng, width, 4 * width)
    x = rng.standard_normal((n, t, width)).astype(np.float32)
    dy = rng.standard_normal((n, t, width)).astype(np.float32)
    fn = make_vit_block_fn(heads, block_frames=2, interpret=True, gelu=gelu)
    y_j, vjp = jax.vjp(fn, jnp.asarray(x), *[jnp.asarray(a) for a in w])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tw = [torch.from_numpy(a) for a in w]
    y_p = fvb.forward_plain(torch.from_numpy(x), tw, heads, gelu)
    dx, grads = fvb.backward_plain(torch.from_numpy(x), torch.from_numpy(dy), tw, heads, gelu)
    assert_grads_close(["y", "dx", *fes.STACK_WEIGHTS], [y_p, dx, *grads],
                       [np.asarray(y_j), *want], {"bqkv": slice(width, 2 * width)})


def test_vit_block_autograd_function_on_the_cpu():
    """With grad, vit_block goes through FusedVitBlock: float32 gradients on
    the float32 masters, equal to backward_plain, and no kernel launch."""
    rng = np.random.default_rng(9)
    w = [torch.from_numpy(a).requires_grad_() for a in layer_weights(rng, 64, 256)]
    x = torch.from_numpy(rng.standard_normal((3, 9, 64)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((3, 9, 64)).astype(np.float32)).to(torch.bfloat16)
    n_fwd, n_bwd = fvb.forward_kernel.launches, fvb.backward_kernel.launches
    y = fvb.vit_block(x.requires_grad_(), w, 2, "quick")
    y.backward(dy)
    _, grads = fvb.backward_plain(x.detach(), dy, [a.detach().to(torch.bfloat16) for a in w], 2,
                                  "quick")
    assert x.grad.dtype == torch.bfloat16
    for a, g in zip(w, grads):
        assert a.grad.dtype == torch.float32
        torch.testing.assert_close(a.grad, g, atol=0, rtol=0)
    assert (fvb.forward_kernel.launches, fvb.backward_kernel.launches) == (n_fwd, n_bwd)


def encoder_stack_case(e, heads, t, layers, seed):
    rng = np.random.default_rng(seed)
    w = layer_weights(rng, e, e, (layers,))
    x = rng.standard_normal((2, t, e)).astype(np.float32)
    dy = rng.standard_normal((2, t, e)).astype(np.float32)
    fn = make_encoder_stack_fn(heads, layers, block_rows=2, interpret=True)
    y_j, vjp = jax.vjp(fn, jnp.asarray(x), *[jnp.asarray(a) for a in w])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tw = [torch.from_numpy(a) for a in w]
    y_p = fes.forward_plain(torch.from_numpy(x), tw, heads)
    dx, grads = fes.backward_plain(torch.from_numpy(x), torch.from_numpy(dy), tw, heads)
    assert_grads_close(["y", "dx", *fes.STACK_WEIGHTS], [y_p, dx, *grads],
                       [np.asarray(y_j), *want], {"bqkv": slice(e, 2 * e)})


@pytest.mark.parametrize("e,heads,t,layers", [
    (128, 2, 10, 2),  # head_dim 64: the flagship's proprioceptive stacks
    (256, 8, 10, 1),  # 8 heads of 32, one layer over 10 frames: its image-frame stack
])
def test_encoder_stack_backward_matches_jax(e, heads, t, layers):
    encoder_stack_case(e, heads, t, layers, seed=e + heads)


def test_decoder_layer_head_dim_64_matches_jax():
    from tests.test_torch_fused_decoder_layer import flat_weights
    from soccerdiffusion_tpu.models.transformer import TransformerDecoderLayer as JaxLayer

    e, heads, b, t, s = 128, 2, 2, 10, 19
    rng = np.random.default_rng(21)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    mem = rng.standard_normal((b, s, e)).astype(np.float32)
    params = JaxLayer(e, heads).init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mem))["params"]
    w = [np.asarray(a, np.float32) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32)
         for a in flat_weights(jax.tree.map(np.asarray, params))]
    dy = rng.standard_normal((b, t, e)).astype(np.float32)
    fn = make_decoder_layer_fn(heads, block_rows=2, interpret=True)
    y_j, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(mem), *[jnp.asarray(a) for a in w])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tw = [torch.from_numpy(a) for a in w]
    y_p = fdl.forward_plain(torch.from_numpy(x), torch.from_numpy(mem), tw, heads)
    dx, dmem, grads = fdl.backward_plain(torch.from_numpy(x), torch.from_numpy(mem),
                                         torch.from_numpy(dy), tw, heads)
    assert_grads_close(["y", "dx", "dmem", *fdl.WEIGHT_NAMES], [y_p, dx, dmem, *grads],
                       [np.asarray(y_j), *want], {"bqkv": slice(e, 2 * e), "bck": slice(None)})


def test_kernel_wrappers_take_head_dim_64():
    """The training kernels' operand checks pass head_dim 64 and refuse 16,
    before any build or launch (so on CPU tensors too)."""
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    w = [torch.from_numpy(a).to(torch.bfloat16)
         for a in layer_weights(np.random.default_rng(0), 128, 512)]
    for heads, ok in ((2, True), (4, True), (8, False)):
        if ok:
            fvb._check(bf(3, 16, 128), w, heads, "quick")
        else:
            with pytest.raises(ValueError, match="head_dim 32 or 64"):
                fvb.backward_kernel(bf(3, 16, 128), bf(3, 16, 128), w, heads)
