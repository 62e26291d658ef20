"""Plain version of the port's FusedDenoiser (the CPU path of
ops/fused_denoise.py) against the JAX FusedDenoiser in interpret mode, in
the eps form, the in-kernel DDIM-coefficient form and the per-step sampler,
float32, at 4 heads x 16, 2 heads x 64 and 2 heads x 128, each side over its own
``pack_context_kv``. Tolerances: float32 summation order (2e-5 absolute per
pass; 1e-4 after a 4-step sample, where 1/sqrt(abar) amplifies eps
differences). Then, without JAX: the pack into the CUDA kernel's
fragment-ordered layout and its inverse, bit for bit, and the shape limits
the denoiser shares with the chunk sampler."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.diffusion import ddim_timesteps as jax_ddim_timesteps
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.ops.fused_denoise import FusedDenoiser as JaxFusedDenoiser
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from soccerdiffusion_tpu_torch.ops.fused_denoise import (FusedDenoiser, kfrag, padded_keys,
                                                         vfrag)
from tests.test_torch_jax_params import (F32_ATOL, SMALL, SMALL_HD64, SMALL_HD128, build_pair,
                                         port_config, to_jax, to_torch)


def setup(b=4, cfg=SMALL):
    jmodel, variables, model, batch, rng = build_pair(cfg, b=b)
    noisy = rng.standard_normal((b, cfg.trajectory_prediction_length,
                                 cfg.num_joints)).astype(np.float32)
    jctx = jmodel.apply(variables, to_jax(batch), False, method=jmodel.encode_context)
    jkv = jmodel.apply(variables, jctx, method=jmodel.precompute_context_kv)
    jfused = JaxFusedDenoiser(jmodel, variables["params"], interpret=True, block_robots=2)
    with torch.no_grad():
        kv = model.precompute_context_kv(model.encode_context(to_torch(batch)))
    fused = FusedDenoiser(model)
    return jmodel, variables, jkv, jfused, model, fused, fused.pack_context_kv(kv), noisy


def jax_step_token(jmodel, variables, t):
    return jmodel.apply(variables, jnp.asarray(t, jnp.int32),
                        method=lambda m, tt: m.step_encoding(tt))[:, 0]


def test_eps_and_ddim_coef_forms_match_jax_kernel(cfg=SMALL, atol=F32_ATOL):
    jmodel, variables, jkv, jfused, model, fused, packed, noisy = setup(cfg=cfg)
    jpacked = jfused.pack_context_kv(jkv)
    jst = jax_step_token(jmodel, variables, [37])[0]
    with torch.no_grad():
        st = model.step_encoding(torch.tensor([37]))[0, 0]
        eps = fused(packed, torch.from_numpy(noisy), st).numpy()
        coefs = np.array([1.3, 0.8, 0.9, 0.4], np.float32)
        x_prev = fused(packed, torch.from_numpy(noisy), st, ddim_coefs=coefs).numpy()
    ref_eps = np.asarray(jfused(jpacked, jnp.asarray(noisy), jst))
    ref_prev = np.asarray(jfused(jpacked, jnp.asarray(noisy), jst,
                                 ddim_coefs=jnp.asarray(coefs)[None]))
    np.testing.assert_allclose(eps, ref_eps, atol=atol, rtol=0)
    np.testing.assert_allclose(x_prev, ref_prev, atol=atol, rtol=0)
    # and against the unfused JAX denoiser
    t = jnp.full((noisy.shape[0],), 37, jnp.int32)
    ref_xla = jmodel.apply(variables, jkv, jnp.asarray(noisy), t, method=jmodel.denoise_with_kv)
    np.testing.assert_allclose(eps, np.asarray(ref_xla), atol=atol, rtol=0)


def test_head_dim_64_matches_jax_kernel():
    """At hidden 128 eps reaches |10|: the float32 bound scales with it (1e-4)."""
    test_eps_and_ddim_coef_forms_match_jax_kernel(SMALL_HD64, atol=1e-4)


def test_head_dim_128_matches_jax_kernel():
    """larger_model.yaml's head_dim at hidden 256: eps reaches |10| as at
    head_dim 64, so the same float32 bound (1e-4)."""
    test_eps_and_ddim_coef_forms_match_jax_kernel(SMALL_HD128, atol=1e-4)


def test_per_step_sampler_matches_jax_kernel(cfg=SMALL):
    jmodel, variables, jkv, jfused, model, fused, packed, noisy = setup(cfg=cfg)
    jpacked = jfused.pack_context_kv(jkv)
    steps = 4
    jsched, sched = jax_make_schedule(100), make_schedule(100)
    ts = jax_ddim_timesteps(100, steps)
    ref = np.asarray(jfused.sample(jpacked, jnp.asarray(noisy),
                                   jax_step_token(jmodel, variables, ts), jsched, steps))
    before = FusedDenoiser.launches
    with torch.no_grad():
        table = model.step_encoding(torch.from_numpy(ts.astype(np.int64)))[:, 0]
        got = fused.sample(packed, torch.from_numpy(noisy), table, sched, steps).numpy()
    assert FusedDenoiser.launches == before
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_per_step_sampler_head_dim_128_matches_jax_kernel():
    test_per_step_sampler_matches_jax_kernel(SMALL_HD128)


# ------------------------------------------------ the kernel's K/V layout

@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_fragment_orders_are_permutations(D):
    """kfrag / vfrag map the (Sp, D) keys x dims of a head one to one onto
    its Sp D slots (Sp a multiple of 32)."""
    s, d = np.meshgrid(np.arange(64), np.arange(D), indexing="ij")
    for frag in (kfrag, vfrag):
        assert np.array_equal(np.sort(frag(s, d, D).ravel()), np.arange(64 * D))


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("S", [17, 31, 301, 311])
def test_pack_round_trips(S, head_dim):
    """pack_context_kv writes element (key s, dim d) of layer l, head h's K
    at kfrag(s, d) and its V at vfrag(s, d) of unit (l, h, K | V), zeros
    at keys S (the step token's slot) .. Sp - 1; unpack_context_kv gives the
    per-layer K/V back bit for bit."""
    cfg = port_config(SMALL, hidden_dim=128, num_decoder_heads=128 // head_dim,
                      compute_dtype="bfloat16")
    den = FusedDenoiser(DiffusionPolicy(cfg))
    L, H, D, b = cfg.num_decoder_layers, den.num_heads, den.head_dim, 3
    rng = np.random.default_rng(S + D)
    kv = [tuple(torch.from_numpy(rng.normal(size=(b, S, H, D)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2)) for _ in range(L)]
    packed = den.pack_context_kv(kv)
    Sp = padded_keys(S)
    assert packed.context_len == S and tuple(packed.kv.shape) == (b, L, H, 2, Sp * D)
    want = torch.zeros((b, L, H, 2, Sp * D), dtype=torch.bfloat16)
    s, d = np.meshgrid(np.arange(S), np.arange(D), indexing="ij")
    for l, pair in enumerate(kv):
        for sel, (t, frag) in enumerate(zip(pair, (kfrag, vfrag))):
            want[:, l, :, sel, torch.from_numpy(frag(s, d, D).ravel())] = (
                t.permute(0, 2, 1, 3).reshape(b, H, S * D))
    assert torch.equal(packed.kv, want)
    for (k, v), (k2, v2) in zip(kv, den.unpack_context_kv(packed)):
        assert torch.equal(k2, k) and torch.equal(v2, v)


# (config changes, context tokens, the message): every shape past the limits
# of the decoder pass the denoiser and the chunk sampler share
BAD_SHAPES = [
    ({"compute_dtype": "float32"}, 301, "bfloat16"),
    ({"num_decoder_heads": 8}, 301, "head_dim 32 or 64"),
    ({"trajectory_prediction_length": 17}, 301, "at most 16 chunk steps"),
    ({"num_joints": 21}, 301, "an even joint count"),
    ({"num_joints": 66}, 301, "an even joint count"),
    ({"hidden_dim": 64, "num_decoder_heads": 2}, 301, "hidden_dim 128"),
    ({"hidden_dim": 256, "num_decoder_heads": 8}, 301, "256 \\(head_dim 64\\)"),
    ({}, 1024, "at most 1023 context tokens"),
    # hidden 512: head_dim 128 only (larger_model.yaml's 4 heads), in its limits
    ({"hidden_dim": 512, "num_decoder_heads": 8}, 311,
     "512 \\(head_dim 128\\); got 512 at head_dim 64"),
    ({"hidden_dim": 512, "num_decoder_heads": 16}, 311, "got 512 at head_dim 32"),
    ({"hidden_dim": 256, "num_decoder_heads": 2}, 311, "got 256 at head_dim 128"),
    ({"hidden_dim": 512, "num_decoder_heads": 4}, 384, "at most 383 context tokens"),
    ({"hidden_dim": 512, "num_decoder_heads": 4, "trajectory_prediction_length": 11}, 311,
     "at most 10 chunk steps at head_dim 128"),
    ({"hidden_dim": 512, "num_decoder_heads": 4, "compute_dtype": "float32"}, 311, "bfloat16"),
]


@pytest.mark.parametrize("cls", [FusedDenoiser, FusedChunkSampler])
@pytest.mark.parametrize("changes,S,message", BAD_SHAPES)
def test_denoiser_and_chunk_refuse_the_same_shapes(changes, S, message, cls):
    cfg = port_config(SMALL, **{"hidden_dim": 128, "num_decoder_heads": 4, "num_joints": 20,
                                "trajectory_prediction_length": 10,
                                "compute_dtype": "bfloat16", **changes})
    with pytest.raises(ValueError, match=message):
        cls(DiffusionPolicy(cfg)).check_kernel_shapes(S)


@pytest.mark.parametrize("cls", [FusedDenoiser, FusedChunkSampler])
@pytest.mark.parametrize("E,H,S", [(128, 4, 301), (256, 4, 311), (128, 2, 543), (512, 4, 311),
                                   (512, 4, 383)],
                         ids=["h128", "flagship", "longest", "larger_model", "longest_hd128"])
def test_ported_serving_shapes_fit_the_kernels(E, H, S, cls):
    """"longest": the most context tokens head_dim 64 at hidden 128 takes
    at the default batch of one robot (a 2-block cluster), whose shared
    memory is the largest plan."""
    cfg = port_config(SMALL, hidden_dim=E, num_decoder_heads=H, num_joints=20,
                      trajectory_prediction_length=10, compute_dtype="bfloat16")
    cls(DiffusionPolicy(cfg)).check_kernel_shapes(S)


def kernel_cfg(E, H, L=4, **changes):
    return port_config(SMALL, hidden_dim=E, num_decoder_heads=H, num_decoder_layers=L,
                       num_joints=20, trajectory_prediction_length=10,
                       compute_dtype="bfloat16", **changes)


# (kernel, hidden, heads, robots, the most context tokens) at 4 layers and 10
# chunk steps: B=1 runs a robot on a 2-block cluster, B=100 on one block (16
# warps: fewer robots than the H100's 132 SMs); the chunk sampler keeps its
# (P, J) solver carry and x0 cache in shared memory, the denoiser none
SMEM_LIMITS = [
    (FusedChunkSampler, 128, 4, 100, 639), (FusedChunkSampler, 128, 4, 1, 639),
    (FusedChunkSampler, 128, 2, 100, 575), (FusedChunkSampler, 128, 2, 1, 543),
    (FusedChunkSampler, 256, 4, 100, 447), (FusedChunkSampler, 256, 4, 1, 415),
    (FusedDenoiser, 128, 4, 100, 671), (FusedDenoiser, 128, 4, 1, 639),
    (FusedDenoiser, 128, 2, 100, 575), (FusedDenoiser, 128, 2, 1, 575),
    (FusedDenoiser, 256, 4, 100, 447), (FusedDenoiser, 256, 4, 1, 415),
]


@pytest.mark.parametrize("cls,E,H,B,most", SMEM_LIMITS,
                         ids=[f"{c.__name__}-h{e}x{h}-B{b}" for c, e, h, b, _ in SMEM_LIMITS])
def test_shared_memory_limits(cls, E, H, B, most):
    """At the limit the plan fits 227 KB; one 32-key block past it the
    wrapper refuses with a ValueError (not the launch's CUDA error) that
    names the limit."""
    op = cls(DiffusionPolicy(kernel_cfg(E, H)))
    op.check_kernel_shapes(most, B)
    assert op.smem_bytes(most, B) <= 232448 < op.smem_bytes(most + 32, B)
    with pytest.raises(ValueError, match=f"at most {most} context tokens there"):
        op.check_kernel_shapes(most + 32, B)


def test_eight_layers_at_hidden_256_in_a_cluster_is_refused():
    """E=256 over 8 layers at S=311: a 2-block cluster needs 232,496 bytes,
    48 past the limit (one block, at B=100, fits)."""
    op = FusedChunkSampler(DiffusionPolicy(kernel_cfg(256, 4, L=8)))
    assert op.smem_bytes(311, 1) == 232496
    with pytest.raises(ValueError, match="232496 bytes"):
        op.check_kernel_shapes(311, 1)
    op.check_kernel_shapes(311, 100)


YAMLS = sorted((Path(__file__).resolve().parent.parent / "soccerdiffusion_tpu_torch" / "training"
                / "configs").glob("*.yaml"))


def context_tokens(m) -> int:
    """The context tokens of a config: each proprioceptive stream in patches,
    a token a frame, the game-state token."""
    streams = ((m.use_action_history, m.action_context_length),
               (m.use_imu, m.imu_context_length),
               (m.use_joint_states, m.joint_state_context_length))
    return (sum(n // m.encoder_patch_size for on, n in streams if on)
            + m.use_images * m.image_context_length + int(m.use_gamestate))


@pytest.mark.parametrize("cls", [FusedDenoiser, FusedChunkSampler])
@pytest.mark.parametrize("path", YAMLS, ids=[p.stem for p in YAMLS])
def test_every_shipped_serving_shape_fits(path, cls):
    """Every shipped YAML's decoder (in bf16, the kernels' dtype) over its own
    context, at one robot (the largest plan) and at its batch."""
    from soccerdiffusion_tpu_torch.config import Config

    config = Config.from_yaml(str(path))
    m = dataclasses.replace(config.model, compute_dtype="bfloat16", use_images=False)
    op = cls(DiffusionPolicy(m))
    S = context_tokens(config.model)
    assert S == {"decoder_only": 0, "sim_scratch": 50}.get(path.stem, 301 + 10 * config.model.use_images)
    for b in (1, config.train.batch_size):
        op.check_kernel_shapes(S, b)
