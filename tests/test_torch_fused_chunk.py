"""Plain version of the port's FusedChunkSampler (the CPU path of
ops/fused_chunk.py) against the JAX FusedChunkSampler in interpret mode,
DDIM and DPM-Solver++(2M), float32, at 4 heads x 16, 2 heads x 64 and 2
heads x 128 (larger_model.yaml's head_dim).
Tolerance 1e-4 absolute: float32
summation order through a 4-step chunk, where 1/sqrt(abar) amplifies the
per-pass eps differences."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.diffusion import parse_solver as jax_parse_solver
from soccerdiffusion_tpu.diffusion import solver_timesteps as jax_solver_timesteps
from soccerdiffusion_tpu.ops.fused_chunk import FusedChunkSampler as JaxFusedChunk
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler, padded_joints, padded_keys
from tests.test_torch_jax_params import (SMALL, SMALL_HD64, SMALL_HD128, build_pair, port_config,
                                         to_jax, to_torch)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp"])
def test_plain_chunk_matches_jax_kernel(solver, cfg=SMALL):
    b, steps = 4, 4
    jmodel, variables, model, batch, rng = build_pair(cfg, b=b)
    noise = rng.standard_normal((b, cfg.trajectory_prediction_length,
                                 cfg.num_joints)).astype(np.float32)
    jsched = jax_make_schedule(100)
    ts = jax_solver_timesteps(jsched, steps, jax_parse_solver(solver)[1])
    jctx = jmodel.apply(variables, to_jax(batch), False, method=jmodel.encode_context)
    jtable = jmodel.apply(variables, jnp.asarray(ts), method=lambda m, tt: m.step_encoding(tt))[:, 0]
    ref = np.asarray(JaxFusedChunk(jmodel, variables["params"], interpret=True, block_robots=2)
                     .sample(jctx, jnp.asarray(noise), jtable, jsched, steps, solver=solver))
    before = FusedChunkSampler.launches
    with torch.no_grad():
        ctx = model.encode_context(to_torch(batch))
        table = model.step_encoding(torch.from_numpy(ts.astype(np.int64)))[:, 0]
        got = FusedChunkSampler(model).sample(ctx, torch.from_numpy(noise), table,
                                              make_schedule(100), steps, solver=solver).numpy()
    assert FusedChunkSampler.launches == before
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp"])
def test_plain_chunk_head_dim_64_matches_jax_kernel(solver):
    test_plain_chunk_matches_jax_kernel(solver, SMALL_HD64)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp"])
def test_plain_chunk_head_dim_128_matches_jax_kernel(solver):
    test_plain_chunk_matches_jax_kernel(solver, SMALL_HD128)


def test_unported_options_raise():
    """The options the port once refused (groups, int8 K/V, "qstat") are
    taken; what raises now is what the JAX sampler refuses (ValueError),
    and int8 over more robots a block than its kernel holds."""
    _, _, model, _, _ = build_pair(SMALL, b=2)
    for kw in ({"group_robots": 2}, {"context_kv_quant": "int8"}, {"cross_orientation": "qstat"}):
        sampler = FusedChunkSampler(model, **kw)
        assert sampler.robots_per_block(64) == 32
    for kw, match in (({"block_robots": 6, "group_robots": 4}, "not divisible"),
                      ({"cross_orientation": "vstat"}, "unknown cross_orientation"),
                      ({"cross_orientation": "qstat", "group_robots": 2}, "requires group_robots=1"),
                      ({"context_kv_quant": "int4"}, "unknown context_kv_quant")):
        with pytest.raises(ValueError, match=match):
            FusedChunkSampler(model, **kw)
    for kw, match in (({"context_kv_quant": "int8", "group_robots": 2}, "group_robots=1"),
                      ({"context_kv_quant": "int8", "block_robots": 64}, "at most 32")):
        with pytest.raises(ValueError, match=match):
            FusedChunkSampler(model, **kw).robots_per_block(64)


def unpacked(sampler):
    """A copy of ``sampler`` whose plain weights are read back from the
    kernel's packed tensors (``kernel_weights``)."""
    cfg = sampler.cfg
    L, H, D, E, J = (sampler.num_layers, sampler.num_heads, sampler.head_dim, cfg.hidden_dim,
                     cfg.num_joints)
    u = copy.copy(sampler)
    (emb_t, u.emb_b, u.pe, qkv_t, u.qkv_b, so_t, u.so_b, cq_t, u.cq_b, co_t, u.co_b, m1_t,
     u.m1_b, m2_t, u.m2_b, u.ln_s, u.ln_b, fc_t, u.fc_b, kv_t, kv_b) = sampler.kernel_weights
    assert emb_t.shape == (E, padded_joints(J)) and not emb_t[:, J:].any()
    t = lambda w: w.transpose(-1, -2)
    u.emb_w = t(emb_t[:, :J])
    u.qkv_w, u.so_w, u.cq_w, u.co_w, u.m1_w, u.m2_w, u.fc_w = map(
        t, (qkv_t, so_t, cq_t, co_t, m1_t, m2_t, fc_t))
    kv = kv_t.reshape(L, H, 2, D, E).permute(0, 4, 2, 1, 3)  # (L, E, K | V, H, D)
    u.ck_w, u.cv_w = kv[:, :, 0].reshape(L, E, E), kv[:, :, 1].reshape(L, E, E)
    kb = kv_b.reshape(L, H, 2, D)
    u.ck_b, u.cv_b = kb[:, :, 0].reshape(L, E), kb[:, :, 1].reshape(L, E)
    return u


@pytest.mark.parametrize("cfg", [SMALL, SMALL_HD64, SMALL_HD128], ids=["4x16", "2x64", "2x128"])
def test_kernel_weights_hold_the_plain_weights(cfg):
    """The layouts the CUDA kernel reads (transposed Dense kernels, the
    zero-padded embedding, the K/V projection ordered by layer, head, K | V)
    are a permutation of the plain version's weights: the plain chunk from
    the unpacked tensors is the plain chunk, bit for bit."""
    torch.manual_seed(0)
    model = DiffusionPolicy(port_config(cfg))
    sampler = FusedChunkSampler(model)
    rng = np.random.default_rng(3)
    b, steps = 3, 3
    context = torch.from_numpy(rng.normal(size=(b, 9, cfg.hidden_dim)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(b, cfg.trajectory_prediction_length,
                                              cfg.num_joints)).astype(np.float32))
    stk, stv = sampler.step_tables(torch.from_numpy(
        rng.normal(size=(steps, cfg.hidden_dim)).astype(np.float32)))
    coefs = solver_coef_table(make_schedule(100), steps, "dpmpp")
    with torch.no_grad():
        ref = sampler.sample_plain(context, noise, stk, stv, coefs)
        got = unpacked(sampler).sample_plain(context, noise, stk, stv, coefs)
    assert torch.equal(got, ref)


def test_padded_sizes():
    assert [padded_joints(j) for j in (6, 12, 20, 40)] == [32, 32, 32, 64]
    assert [padded_keys(s) for s in (17, 30, 31, 301, 311, 312)] == [32, 32, 32, 320, 320, 320]
