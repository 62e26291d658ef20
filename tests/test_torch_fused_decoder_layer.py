"""The fused decoder layer's plain versions (ops/fused_decoder_layer.py)
against the JAX kernel (soccerdiffusion_tpu/ops/fused_decoder_layer.py,
interpret mode): forward, the hand-derived backward against jax.grad
through the JAX custom_vjp, and against torch autograd of the plain
forward; in float32 and in bfloat16.

E=64, H=2 (head_dim 32), B=4, T=10, S=19: T and S are no multiple of 8, so
the JAX side takes its padding path. Tolerances: float32 forward 2e-4 and
backward 2e-3 absolute (as tests/test_fused_decoder_layer.py); bfloat16
2e-2 x max|JAX| of each tensor (a few bf16 roundings of 2^-8 flipped by
summation order), where the two gradients that are zero in exact
arithmetic (the key bias of each attention) are held against the largest
gradient of the layer's weights instead of their own scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.models.transformer import TransformerDecoderLayer as JaxLayer
from soccerdiffusion_tpu.ops.fused_decoder_layer import make_decoder_layer_fn
from soccerdiffusion_tpu_torch.models.transformer import FusedTransformerDecoderLayer
from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import (
    WEIGHT_NAMES,
    FusedDecoderLayer,
    backward_plain,
    decoder_layer,
    forward_plain,
    layer_weights,
)
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params

E, H, B, T, S = 64, 2, 4, 10, 19
BF16_TOL = 2e-2


def flat_weights(params):
    sa, ca, mlp = params["self_attn"], params["cross_attn"], params["mlp"]
    kb = lambda d: (d["kernel"], d["bias"])
    return [params["norm1"]["scale"], params["norm1"]["bias"],
            np.concatenate([sa["q_proj"]["kernel"], sa["k_proj"]["kernel"], sa["v_proj"]["kernel"]], 1),
            np.concatenate([sa["q_proj"]["bias"], sa["k_proj"]["bias"], sa["v_proj"]["bias"]]),
            *kb(sa["out_proj"]), params["norm2"]["scale"], params["norm2"]["bias"],
            *kb(ca["q_proj"]), *kb(ca["k_proj"]), *kb(ca["v_proj"]), *kb(ca["out_proj"]),
            params["norm3"]["scale"], params["norm3"]["bias"], *kb(mlp["linear1"]), *kb(mlp["linear2"])]


def setup(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mem = rng.standard_normal((B, S, E)).astype(np.float32)
    params = JaxLayer(E, H).init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(mem))["params"]
    params = jax.tree.map(np.asarray, params)
    w = [np.asarray(a, np.float32) for a in flat_weights(params)]
    # nonzero biases and LN offsets, so every gradient path carries signal
    w = [a + 0.1 * rng.standard_normal(a.shape).astype(np.float32) for a in w]
    dy = rng.standard_normal((B, T, E)).astype(np.float32)
    return x, mem, w, dy, params


def jax_grads(x, mem, w, dy, dtype):
    fn = make_decoder_layer_fn(H, block_rows=2, interpret=True)
    c = lambda a: jnp.asarray(a, dtype)

    def loss(ws, xx, mm):
        return jnp.sum(fn(xx, mm, *ws).astype(jnp.float32) * jnp.asarray(dy))

    y = fn(c(x), c(mem), *[c(a) for a in w])
    dw, dx, dmem = jax.grad(loss, argnums=(0, 1, 2))([c(a) for a in w], c(x), c(mem))
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return f(y), f(dx), f(dmem), [f(a) for a in dw]


def port_grads(x, mem, w, dy, dtype):
    t = lambda a: torch.from_numpy(a).to(dtype)
    ws = [t(a) for a in w]
    y = forward_plain(t(x), t(mem), ws, H)
    dx, dmem, dw = backward_plain(t(x), t(mem), t(dy), ws, H)
    f = lambda a: a.float().numpy()
    return f(y), f(dx), f(dmem), [f(a) for a in dw]


def zero_in_exact_math(name, n):
    """The slice of a gradient (n wide) that vanishes in exact arithmetic."""
    return {"bck": slice(None), "bqkv": slice(n // 3, 2 * n // 3)}.get(name)


def assert_bf16_close(got, want, what):
    np.testing.assert_array_less(np.abs(got - want).max(), BF16_TOL * np.abs(want).max() + 1e-30,
                                 err_msg=what)


def test_forward_matches_jax_float32():
    x, mem, w, dy, _ = setup()
    y_j, *_ = jax_grads(x, mem, w, dy, jnp.float32)
    y_p = forward_plain(torch.from_numpy(x), torch.from_numpy(mem), [torch.from_numpy(a) for a in w], H)
    np.testing.assert_allclose(y_p.numpy(), y_j, atol=2e-4, rtol=0)


def test_backward_matches_jax_grad_float32():
    x, mem, w, dy, _ = setup(1)
    _, dx_j, dmem_j, dw_j = jax_grads(x, mem, w, dy, jnp.float32)
    _, dx_p, dmem_p, dw_p = port_grads(x, mem, w, dy, torch.float32)
    np.testing.assert_allclose(dx_p, dx_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(dmem_p, dmem_j, atol=2e-3, rtol=0)
    for name, got, want in zip(WEIGHT_NAMES, dw_p, dw_j):
        np.testing.assert_allclose(got, want.reshape(got.shape), atol=2e-3, rtol=0, err_msg=name)


def test_backward_matches_torch_autograd_float32():
    """The hand-derived backward is the derivative of the plain forward."""
    x, mem, w, dy, _ = setup(2)
    xs = torch.from_numpy(x).requires_grad_()
    ms = torch.from_numpy(mem).requires_grad_()
    ws = [torch.from_numpy(a).requires_grad_() for a in w]
    (forward_plain(xs, ms, ws, H) * torch.from_numpy(dy)).sum().backward()
    dx, dmem, dw = backward_plain(xs.detach(), ms.detach(), torch.from_numpy(dy),
                                  [a.detach() for a in ws], H)
    torch.testing.assert_close(dx, xs.grad, atol=1e-4, rtol=0)
    torch.testing.assert_close(dmem, ms.grad, atol=1e-4, rtol=0)
    for name, got, a in zip(WEIGHT_NAMES, dw, ws):
        torch.testing.assert_close(got, a.grad, atol=1e-4, rtol=0, msg=name)


def test_bfloat16_matches_jax_kernel():
    x, mem, w, dy, _ = setup(3)
    y_j, dx_j, dmem_j, dw_j = jax_grads(x, mem, w, dy, jnp.bfloat16)
    y_p, dx_p, dmem_p, dw_p = port_grads(x, mem, w, dy, torch.bfloat16)
    assert_bf16_close(y_p, y_j, "y")
    assert_bf16_close(dx_p, dx_j, "dx")
    assert_bf16_close(dmem_p, dmem_j, "dmem")
    layer_max = max(np.abs(a).max() for a in dw_j)
    for name, got, want in zip(WEIGHT_NAMES, dw_p, dw_j):
        want = want.reshape(got.shape)
        zero = zero_in_exact_math(name, got.shape[-1])
        if zero is not None:
            np.testing.assert_array_less(np.abs(got[..., zero] - want[..., zero]).max(),
                                         BF16_TOL * layer_max, err_msg=name)
            keep = np.ones(got.shape[-1], bool)
            keep[zero] = False
            got, want = got[..., keep], want[..., keep]
            if not got.size:
                continue
        assert_bf16_close(got, want, name)


def test_module_routes_through_the_function_and_falls_back():
    """The fused module uses the op with memory and the plain math with
    cached K/V or without a memory, on the plain layer's parameters."""
    x, mem, _, _, params = setup(4)
    layer = load_jax_params(FusedTransformerDecoderLayer(E, H), params)
    xs, ms = torch.from_numpy(x), torch.from_numpy(mem)
    with torch.no_grad():
        fused = layer(xs, ms)
        plain = super(FusedTransformerDecoderLayer, layer).forward(xs, ms)
        via_kv = layer(xs, None, layer.compute_memory_kv(ms))
        self_only = layer(xs)
        direct = decoder_layer(xs, ms, layer_weights(layer), H)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(via_kv.numpy(), plain.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(fused.numpy(), direct.numpy())
    assert self_only.shape == xs.shape


def test_gradients_reach_the_float32_masters():
    x, mem, _, dy, params = setup(5)
    layer = load_jax_params(FusedTransformerDecoderLayer(E, H), params)
    xs = torch.from_numpy(x).to(torch.bfloat16)
    ms = torch.from_numpy(mem).to(torch.bfloat16).requires_grad_()
    (layer(xs, ms).float() * torch.from_numpy(dy)).sum().backward()
    assert ms.grad.dtype == torch.bfloat16
    for name, p in layer.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
    assert FusedDecoderLayer.fwd_launches == 0 and FusedDecoderLayer.bwd_launches == 0


def test_kernel_wrapper_rejects_an_mlp_width_off_8():
    """The decoder's operand check reads the MLP width from w1 and names it;
    it raises before any launch, so it runs on CPU tensors too."""
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import forward_kernel

    x, mem, w, _, _ = setup(6)
    ff = 12
    w[18], w[19], w[20] = (np.zeros(s, np.float32) for s in ((E, ff), (ff,), (ff, E)))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8, got 12"):
        forward_kernel(bf(x), bf(mem), [bf(a) for a in w], H)


@pytest.mark.parametrize("heads,ff", [(2, 64), (4, 96)])
def test_kernel_weights_are_the_layouts_the_kernels_read(heads, ff):
    """kernel_weights (the CUDA kernels' extra layouts, made on the CPU here):
    the six forward-product weights transposed, and the memory's K/V
    projection ordered by head -- rows h 2D .. h 2D + D - 1 of wkv_t with
    bias bkv give head h's keys, the next D its values -- and [wck | wcv]."""
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import kernel_weights

    rng = np.random.default_rng(heads)
    shapes = [(E,), (E,), (E, 3 * E), (3 * E,), (E, E), (E,), (E,), (E,), (E, E), (E,), (E, E),
              (E,), (E, E), (E,), (E, E), (E,), (E,), (E,), (E, ff), (ff,), (ff, E), (E,)]
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    kw = kernel_weights(w, heads)
    for got, i in zip(kw[:6], (2, 4, 8, 14, 18, 20)):
        assert got.is_contiguous() and torch.equal(got, w[i].t())
    wkv_t, bkv, wkvc = kw[6:]
    assert wkv_t.is_contiguous() and torch.equal(wkvc, torch.cat([w[10], w[12]], dim=1))
    mem = torch.from_numpy(rng.normal(size=(S, E)).astype(np.float32))
    kv = mem @ wkv_t.t() + bkv
    k, v, D = mem @ w[10] + w[11], mem @ w[12] + w[13], E // heads
    for h in range(heads):
        torch.testing.assert_close(kv[:, 2 * h * D:2 * h * D + D], k[:, h * D:(h + 1) * D])
        torch.testing.assert_close(kv[:, 2 * h * D + D:2 * (h + 1) * D], v[:, h * D:(h + 1) * D])
