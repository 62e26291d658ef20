"""Plain version of the port's FusedDenoiser (the CPU path of
ops/fused_denoise.py) against the JAX FusedDenoiser in interpret mode, in
the eps form, the in-kernel DDIM-coefficient form and the per-step sampler,
float32, at 4 heads x 16 and 2 heads x 64. Tolerances: float32 summation order (2e-5 absolute per pass; 1e-4
after a 4-step sample, where 1/sqrt(abar) amplifies eps differences)."""

import jax.numpy as jnp
import numpy as np
import torch

from soccerdiffusion_tpu.diffusion import ddim_timesteps as jax_ddim_timesteps
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.ops.fused_denoise import FusedDenoiser as JaxFusedDenoiser
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
from tests.test_torch_jax_params import F32_ATOL, SMALL, SMALL_HD64, build_pair, to_jax, to_torch


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


def test_per_step_sampler_matches_jax_kernel():
    jmodel, variables, jkv, jfused, model, fused, packed, noisy = setup()
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
