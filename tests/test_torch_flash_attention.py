"""The port's flash attention (ops/flash_attention.py) and the "pallas"
attention backend against the JAX package, on the CPU.

  * ``plain_flash_attention`` against the JAX Pallas kernel in interpret
    mode at the shapes of tests/test_flash_attention.py and its streamed
    shape (Tk = 1536): 2e-5 in float32 (summation order), 2e-2 in bf16 (one
    bf16 rounding of the output, 2^-8 relative, at unit-scale values);
  * the op's gradients (the plain backward, CPU tensors) against jax.grad of
    the interpret-mode kernel: 2e-4, 5e-4 streamed (the tolerances of the
    JAX package's own flash tests);
  * ``resolve_attention_fn`` and the "auto" predicate;
  * a small flagship-shaped model with every attention through the backend
    (2 ViT blocks of width 64 over 56 px frames in patches of 28, hidden 64
    with 2 decoder heads, the three fused knobs off, ``attention_impl=
    "pallas"``): forward and ``encode_context`` against the JAX model with
    the same parameters at F32_ATOL, in bf16 within 2e-2 of the output's
    scale, and 3 AdamW steps against the JAX trainer within 1e-5.

The JAX side runs ``soccerdiffusion_tpu.ops.flash_attention.flash_attention``
with ``interpret=True``: the tests patch that module attribute, which the
JAX package's ``resolve_attention_fn`` reads at call time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soccerdiffusion_tpu.ops.flash_attention as jax_flash
from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu_torch.models import attention
from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops.flash_attention import (
    FlashAttention,
    check_operands,
    flash_attention,
    plain_flash_attention,
)
from tests.test_torch_flagship_training import three_steps_match_the_jax_trainer
from tests.test_torch_jax_params import F32_ATOL, build_pair, to_jax, to_torch

SHAPES = [  # (b, tq, tk, h, d), tests/test_flash_attention.py's
    (2, 10, 111, 4, 32),  # decoder cross-attention
    (2, 111, 111, 4, 32),  # encoder self-attention
    (1, 10, 10, 4, 32),  # decoder self-attention
    (1, 196, 196, 4, 48),  # ViT patches
    (3, 7, 13, 2, 8),  # unaligned sizes
]
STREAMED = (1, 16, 1536, 2, 16)  # the TPU kernel's streamed regime (Tk > 1024)

FLASH = ModelConfig(
    num_joints=6, hidden_dim=64, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=12, imu_context_length=12, use_images=True,
    image_encoder_type="vit", image_resolution=56, image_context_length=2, vit_patch_size=28,
    vit_width=64, vit_depth=2, vit_fused_gelu="quick", num_image_sequence_encoder_layers=1,
    num_action_history_encoder_layers=1, num_imu_encoder_layers=1, joint_state_encoder_layers=1,
    num_decoder_layers=1, num_decoder_heads=2, vit_fused_block=False, encoder_fused_stack=False,
    decoder_fused_block=False, attention_impl="pallas")


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's flash kernel in interpret mode."""
    kernel = jax_flash.flash_attention
    monkeypatch.setattr(jax_flash, "flash_attention",
                        lambda q, k, v: kernel(q, k, v, interpret=True))


@pytest.fixture
def no_kernel(monkeypatch):
    """CPU tensors must never reach the CUDA kernel library."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(_build, "library", refuse)


def operands(shape, seed):
    b, tq, tk, h, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d), (b, tq, h, d))]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", SHAPES + [STREAMED])
def test_plain_version_matches_the_jax_kernel(shape, dtype, tol, no_kernel):
    q, k, v, _ = operands(shape, 0)
    jq, jk, jv = (jnp.asarray(a, dtype=dtype) for a in (q, k, v))
    want = np.asarray(jax_flash.flash_attention(jq, jk, jv, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    got = plain_flash_attention(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    with torch.no_grad():  # the op on CPU tensors is the plain version
        torch.testing.assert_close(flash_attention(tq, tk, tv), got, atol=0, rtol=0)


@pytest.mark.parametrize("shape", SHAPES + [STREAMED])
def test_gradients_match_the_jax_kernel(shape, no_kernel):
    q, k, v, cot = operands(shape, 1)
    loss = lambda *a: jnp.sum(jax_flash.flash_attention(*a, interpret=True) * cot)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tensors = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    n = FlashAttention.launches, FlashAttention.backward_launches
    (flash_attention(*tensors) * torch.from_numpy(cot)).sum().backward()
    assert (FlashAttention.launches, FlashAttention.backward_launches) == n
    tol = 5e-4 if shape == STREAMED else 2e-4
    for name, t, w in zip("qkv", tensors, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=tol, rtol=tol,
                                   err_msg=f"d{name}")


def test_operands_outside_the_contract_raise():
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)
    for q, k, v in ((z(1, 4, 2, 129), z(1, 4, 2, 129), z(1, 4, 2, 129)),  # head_dim > 128
                    (z(1, 4, 2, 8), z(1, 4, 2, 8), z(1, 5, 2, 8)),  # k / v lengths differ
                    (z(1, 4, 2, 8), z(1, 4, 3, 8), z(1, 4, 3, 8)),  # heads differ
                    (z(1, 4, 2, 8), z(1, 4, 2, 8, dtype=torch.bfloat16), z(1, 4, 2, 8)),
                    (z(1, 4, 2, 8, dtype=torch.float16),) * 3,
                    (z(1, 0, 2, 8), z(1, 4, 2, 8), z(1, 4, 2, 8))):
        with pytest.raises(ValueError):
            check_operands(q, k, v)
        with pytest.raises(ValueError):
            flash_attention(q, k, v)


def test_resolve_attention_fn():
    assert attention.resolve_attention_fn("xla") is attention.plain_attention
    assert attention.resolve_attention_fn("pallas") is flash_attention
    assert attention.resolve_attention_fn("auto") is attention.auto_attention
    assert attention.resolve_attention_fn("ring") is attention.auto_ring_attention
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.resolve_attention_fn("cudnn")


def test_auto_takes_the_kernel_on_the_card_from_256_squared_scores():
    """The JAX package's threshold (Tq * Tk >= 256^2) with the TPU read as
    the card; CPU tensors always take plain_attention."""
    assert attention.AUTO_FLASH_SCORES == 256 * 256
    assert attention.auto_takes_flash("cuda", 256, 256)
    assert attention.auto_takes_flash("cuda", 64, 1024)
    assert not attention.auto_takes_flash("cuda", 255, 257)  # 256^2 - 1
    assert not attention.auto_takes_flash("cuda", 65535, 1)
    assert not attention.auto_takes_flash("cpu", 512, 512)
    # every shipped shape stays on the plain path (the largest: 100 x 100 in the stacks)
    assert not attention.auto_takes_flash("cuda", 100, 100)
    q = torch.randn(1, 300, 2, 8)
    n = FlashAttention.launches
    torch.testing.assert_close(attention.auto_attention(q, q, q), attention.plain_attention(q, q, q),
                               atol=0, rtol=0)
    assert FlashAttention.launches == n


def test_the_fused_layers_ignore_the_backend():
    """As in the JAX package: only the unfused layers take attention_impl;
    the fused decoder layer's plain branch (cached K/V) attends plainly."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from tests.test_torch_jax_params import port_config

    fused = DiffusionPolicy(port_config(FLASH, decoder_fused_block=True, encoder_fused_stack=True))
    assert fused.diffusion_action_generator.decoder.layers[0].self_attn.attend \
        is attention.plain_attention
    plain = DiffusionPolicy(port_config(FLASH))
    attends = {m.attend for m in plain.modules() if isinstance(m, attention.MultiHeadAttention)}
    assert attends == {flash_attention}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_flagship_forward_matches_jax(dtype, jax_interpret, no_kernel):
    """The whole model with every attention through the backend, through
    the JAX model's forward with its flash kernel (interpret mode)."""
    cfg = dataclasses.replace(FLASH, compute_dtype=dtype)
    jmodel, variables, model, batch, rng = build_pair(cfg, b=3)
    noisy = rng.standard_normal((3, cfg.trajectory_prediction_length,
                                 cfg.num_joints)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    ref_ctx = np.asarray(jmodel.apply(variables, to_jax(batch), False,
                                      method=jmodel.encode_context), np.float32)
    ref = np.asarray(jmodel.apply(variables, to_jax(batch), jnp.asarray(noisy), jnp.asarray(t),
                                  False), np.float32)
    n = FlashAttention.launches
    with torch.no_grad():
        ctx = model.encode_context(to_torch(batch)).float().numpy()
        got = model(to_torch(batch), torch.from_numpy(noisy), torch.from_numpy(t)).float().numpy()
    assert FlashAttention.launches == n  # CPU tensors: the plain versions
    for name, g, w in (("context", ctx, ref_ctx), ("eps", got, ref)):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0, err_msg=name)
        else:
            err, scale = np.abs(g - w).max(), np.abs(w).max()
            assert err <= 2e-2 * scale, (name, err, scale)


def test_three_flash_flagship_steps_match_the_jax_trainer(jax_interpret, no_kernel):
    three_steps_match_the_jax_trainer(FLASH)


# ------------------------------------------------ the P split, emulated
# The bf16 flash kernels keep the TPU kernel's fp32 probabilities (and ds)
# on bf16 tensor cores by splitting each into hi = bf16(x) and lo = bf16(x -
# hi) and summing two products against the bf16 operand in fp32
# (csrc/mma.cuh:pv_step). Emulated here in plain torch at the flash shapes
# of chip_smoke.py (batch cut to 1-3): the split product stays within
# SPLIT_BOUND of the exact product, relative to max(|x| |B|) (hi + lo keeps
# 16 of x's 24 mantissa bits: 2^-18 per element, plus the fp32 sums), while
# one product of bf16(x) is at least 16x further off.
SPLIT_BOUND = 2.0 ** -16
SPLIT_SHAPES = [  # (b, tq, tk, h, d)
    (2, 64, 64, 4, 64), (2, 10, 10, 8, 32), (2, 100, 100, 4, 64), (2, 10, 10, 4, 64),
    (2, 10, 312, 4, 64), (2, 100, 100, 4, 32), (1, 256, 256, 4, 64), (1, 64, 1536, 4, 64),
    (3, 7, 13, 2, 8), (2, 196, 196, 4, 48),
]


def split_product(x, b):
    """x @ b with x as two bf16 halves and fp32 sums, as the kernels do."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi @ b + lo @ b


def _split_errors(x, b):
    exact = x.double() @ b.double()
    scale = (x.double().abs() @ b.double().abs()).amax()
    err = lambda got: ((got.double() - exact).abs().amax() / scale).item()
    return err(split_product(x, b)), err(x.to(torch.bfloat16).float() @ b)


@pytest.mark.parametrize("operand", ["p_v", "ds_k"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_p_split_product_keeps_fp32_probabilities(shape, operand):
    """P v (the forward's unnormalised probabilities against bf16 values)
    and ds k (the backward's signed ds against bf16 keys)."""
    b, tq, tk, h, d = shape
    rng = np.random.default_rng(tq * tk + d)
    bf = lambda t: torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)).to(
        torch.bfloat16).float()
    q, k, v, do = bf(tq), bf(tk), bf(tk), bf(tq)
    s = q @ k.transpose(-1, -2) / np.sqrt(d)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if operand == "p_v":
        split, rounded = _split_errors(p, v)
    else:
        pn = p / p.sum(-1, keepdim=True)
        dp = do @ v.transpose(-1, -2)
        ds = pn * (dp - (dp * pn).sum(-1, keepdim=True)) / np.sqrt(d)
        split, rounded = _split_errors(ds, k)
    assert split <= SPLIT_BOUND, split
    assert rounded >= 16 * split, (rounded, split)
