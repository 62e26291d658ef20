"""The fused encoder stack's plain versions (ops/fused_encoder_stack.py)
against the JAX kernel (soccerdiffusion_tpu/ops/fused_encoder_stack.py,
interpret mode): forward, the hand-derived backward against jax.grad
through the JAX custom_vjp, and against torch autograd of the plain
forward; in float32 and in bfloat16.

E=64, H=2 (head_dim 32), B=4, T=10 (no multiple of 8: the JAX side pads),
L=2; the forward also at 2 heads x 64 (the CUDA kernel's other instance)
and 4 heads x 16. Tolerances as in tests/test_torch_fused_decoder_layer.py: float32
forward 2e-4, backward 2e-3 absolute; bfloat16 2e-2 x max|JAX| of each
tensor, the query-key bias's key third (zero in exact arithmetic) held
against the largest gradient of the stack's weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.models.transformer import TransformerEncoder as JaxEncoder
from soccerdiffusion_tpu.ops.fused_encoder_stack import make_encoder_stack_fn
from soccerdiffusion_tpu_torch.models.transformer import TransformerEncoder
from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import (
    STACK_WEIGHTS,
    FusedEncoderStack,
    backward_plain,
    encoder_stack,
    forward_plain,
    stack_weights,
)
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params

E, H, B, T, L = 64, 2, 4, 10, 2
BF16_TOL = 2e-2


def setup(seed=0, e=E, h=H):
    """Numpy inputs, stacked weights (with nonzero biases / LN offsets) and
    the flax params of a plain JAX encoder holding the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, e)).astype(np.float32)
    params = JaxEncoder(e, h, L).init(jax.random.key(seed), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    layers = [params[f"layer_{i}"] for i in range(L)]
    sa = lambda p: p["self_attn"]
    st = lambda f: np.stack([f(p) for p in layers]).astype(np.float32)
    w = [st(lambda p: p["norm1"]["scale"]), st(lambda p: p["norm1"]["bias"]),
         st(lambda p: np.concatenate([sa(p)[n]["kernel"] for n in ("q_proj", "k_proj", "v_proj")], 1)),
         st(lambda p: np.concatenate([sa(p)[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")])),
         st(lambda p: sa(p)["out_proj"]["kernel"]), st(lambda p: sa(p)["out_proj"]["bias"]),
         st(lambda p: p["norm2"]["scale"]), st(lambda p: p["norm2"]["bias"]),
         st(lambda p: p["mlp"]["linear1"]["kernel"]), st(lambda p: p["mlp"]["linear1"]["bias"]),
         st(lambda p: p["mlp"]["linear2"]["kernel"]), st(lambda p: p["mlp"]["linear2"]["bias"])]
    dy = rng.standard_normal((B, T, e)).astype(np.float32)
    return x, w, dy, params


def jax_run(x, w, dy, dtype, h=H):
    fn = make_encoder_stack_fn(h, L, block_rows=2, interpret=True)
    c = lambda a: jnp.asarray(a, dtype)

    def loss(ws, xx):
        return jnp.sum(fn(xx, *ws).astype(jnp.float32) * jnp.asarray(dy))

    y = fn(c(x), *[c(a) for a in w])
    dw, dx = jax.grad(loss, argnums=(0, 1))([c(a) for a in w], c(x))
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return f(y), f(dx), [f(a) for a in dw]


def port_run(x, w, dy, dtype):
    t = lambda a: torch.from_numpy(a).to(dtype)
    ws = [t(a) for a in w]
    y = forward_plain(t(x), ws, H)
    dx, dw = backward_plain(t(x), t(dy), ws, H)
    f = lambda a: a.float().numpy()
    return f(y), f(dx), [f(a) for a in dw]


def test_forward_matches_jax_float32():
    x, w, dy, _ = setup()
    y_j, _, _ = jax_run(x, w, dy, jnp.float32)
    y_p = forward_plain(torch.from_numpy(x), [torch.from_numpy(a) for a in w], H)
    np.testing.assert_allclose(y_p.numpy(), y_j, atol=2e-4, rtol=0)


@pytest.mark.parametrize("e,h", [(128, 2), (64, 4)])
def test_forward_head_dims_match_jax(e, h):
    """2 heads x 64 (the flagship's head dim) and 4 heads x 16."""
    x, w, dy, _ = setup(6, e, h)
    y_j, _, _ = jax_run(x, w, dy, jnp.float32, h)
    y_p = forward_plain(torch.from_numpy(x), [torch.from_numpy(a) for a in w], h)
    np.testing.assert_allclose(y_p.numpy(), y_j, atol=2e-4, rtol=0)


def test_head_dim_64_backward_kernel_raises(monkeypatch):
    """The CUDA backward takes head_dim 32 and 64: at 64 its operand check
    passes and the call goes on to the kernel library (stubbed here to
    raise); head_dim 16 raises ValueError before any build or launch (so on
    CPU tensors too)."""
    from soccerdiffusion_tpu_torch.ops import _build
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import backward_kernel

    def library():
        raise LookupError("reached the kernel library")

    monkeypatch.setattr(_build, "library", library)
    x, w, dy, _ = setup(7, 128, 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    acts = torch.zeros((L, B, T, 128))
    with pytest.raises(LookupError, match="kernel library"):
        backward_kernel(acts, bf(dy), [bf(a) for a in w], 2)
    with pytest.raises(ValueError, match="head_dim 32 or 64, got 16"):
        backward_kernel(acts, bf(dy), [bf(a) for a in w], 8)


def test_backward_matches_jax_grad_float32():
    x, w, dy, _ = setup(1)
    _, dx_j, dw_j = jax_run(x, w, dy, jnp.float32)
    _, dx_p, dw_p = port_run(x, w, dy, torch.float32)
    np.testing.assert_allclose(dx_p, dx_j, atol=2e-3, rtol=0)
    for name, got, want in zip(STACK_WEIGHTS, dw_p, dw_j):
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=name)


def test_backward_matches_torch_autograd_float32():
    x, w, dy, _ = setup(2)
    xs = torch.from_numpy(x).requires_grad_()
    ws = [torch.from_numpy(a).requires_grad_() for a in w]
    (forward_plain(xs, ws, H) * torch.from_numpy(dy)).sum().backward()
    dx, dw = backward_plain(xs.detach(), torch.from_numpy(dy), [a.detach() for a in ws], H)
    torch.testing.assert_close(dx, xs.grad, atol=1e-4, rtol=0)
    for name, got, a in zip(STACK_WEIGHTS, dw, ws):
        torch.testing.assert_close(got, a.grad, atol=1e-4, rtol=0, msg=name)


def test_bfloat16_matches_jax_kernel():
    x, w, dy, _ = setup(3)
    y_j, dx_j, dw_j = jax_run(x, w, dy, jnp.bfloat16)
    y_p, dx_p, dw_p = port_run(x, w, dy, torch.bfloat16)
    scale = lambda a: BF16_TOL * np.abs(a).max()
    assert np.abs(y_p - y_j).max() <= scale(y_j)
    assert np.abs(dx_p - dx_j).max() <= scale(dx_j)
    stack_max = max(np.abs(a).max() for a in dw_j)
    for name, got, want in zip(STACK_WEIGHTS, dw_p, dw_j):
        if name == "bqkv":  # the key third is zero in exact arithmetic
            assert np.abs(got[:, E:2 * E] - want[:, E:2 * E]).max() <= BF16_TOL * stack_max, name
            got, want = np.delete(got, np.s_[E:2 * E], 1), np.delete(want, np.s_[E:2 * E], 1)
        assert np.abs(got - want).max() <= scale(want), name


def test_module_routes_through_the_function():
    """TransformerEncoder(fused_stack=True) equals the plain layers on the
    same parameters, forward and backward, in float32."""
    x, _, dy, params = setup(4)
    fused = load_jax_params(TransformerEncoder(E, H, L, fused_stack=True), params)
    plain = load_jax_params(TransformerEncoder(E, H, L), params)
    for enc in (fused, plain):
        (enc(torch.from_numpy(x)) * torch.from_numpy(dy)).sum().backward()
    for (name, a), b in zip(fused.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=0, msg=name)
    with torch.no_grad():
        torch.testing.assert_close(fused(torch.from_numpy(x)), plain(torch.from_numpy(x)),
                                   atol=2e-5, rtol=0)
        direct = encoder_stack(torch.from_numpy(x), stack_weights(fused.layers), H)
    assert FusedEncoderStack.fwd_launches == 0 and direct.shape == (B, T, E)



def test_kernel_wrapper_rejects_an_mlp_width_off_8():
    """The stack's operand check reads the MLP width from w1 and names it;
    it raises before any launch, so it runs on CPU tensors too."""
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import forward_kernel

    x, w, _, _ = setup(5)
    ff = 12
    w[8], w[9], w[10] = (np.zeros(s, np.float32) for s in ((L, E, ff), (L, ff), (L, ff, E)))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8, got 12"):
        forward_kernel(bf(x), [bf(a) for a in w], H)


def test_forward_kernel_checks_shared_memory(monkeypatch):
    """The forward kernel keeps a robot's bf16 operands in shared memory:
    the flagship's T=100 x 256 fits and goes on to the kernel library
    (stubbed here to raise), 128 x 256 raises ValueError before any build or
    launch (so on CPU tensors too)."""
    from soccerdiffusion_tpu_torch.ops import _build
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import forward_kernel, fwd_smem_bytes

    def library():
        raise LookupError("reached the kernel library")

    monkeypatch.setattr(_build, "library", library)
    assert fwd_smem_bytes(100, 256) == 208000  # 203 KB of 227 KB
    shapes = [(1, 256), (1, 256), (1, 256, 768), (1, 768), (1, 256, 256), (1, 256), (1, 256),
              (1, 256), (1, 256, 256), (1, 256), (1, 256, 256), (1, 256)]
    w = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    with pytest.raises(LookupError, match="kernel library"):
        forward_kernel(torch.zeros(2, 100, 256, dtype=torch.bfloat16), w, 4)
    with pytest.raises(ValueError, match="shared memory"):
        forward_kernel(torch.zeros(2, 128, 256, dtype=torch.bfloat16), w, 4)
