"""The port's schedule, DDIM timesteps, solver table and samplers against
the JAX package. The tables are built from the same float32 schedule in
float64 numpy, so they agree exactly; the samplers run float32 torch
against float32 JAX (1e-5 absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu import diffusion as jd
from soccerdiffusion_tpu_torch import diffusion as td


@pytest.mark.parametrize("beta_schedule", ["squaredcos_cap_v2", "linear", "scaled_linear"])
def test_schedule_tables_equal(beta_schedule):
    ref, got = jd.make_schedule(1000, beta_schedule), td.make_schedule(1000, beta_schedule)
    np.testing.assert_array_equal(got.betas, np.asarray(ref.betas))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(ref.alphas_cumprod))
    assert got.final_alpha_cumprod == ref.final_alpha_cumprod


@pytest.mark.parametrize("solver", ["ddim", "dpmpp", "dpmpp@lambda", "ddim@lambda"])
@pytest.mark.parametrize("steps", [1, 10, 30])
def test_timesteps_and_coef_table_equal(solver, steps):
    ref_s, got_s = jd.make_schedule(1000), td.make_schedule(1000)
    spacing = jd.parse_solver(solver)[1]
    assert td.parse_solver(solver) == jd.parse_solver(solver)
    np.testing.assert_array_equal(td.solver_timesteps(got_s, steps, spacing),
                                  jd.solver_timesteps(ref_s, steps, spacing))
    np.testing.assert_array_equal(td.solver_coef_table(got_s, steps, solver),
                                  jd.solver_coef_table(ref_s, steps, solver))
    np.testing.assert_array_equal(td.ddim_timesteps(1000, steps), jd.ddim_timesteps(1000, steps))


def test_bad_solver_raises():
    for bad in ("euler", "ddim@karras"):
        with pytest.raises(ValueError):
            td.parse_solver(bad)


def _oracle(schedule, x0):
    """Exact eps predictor for a known x0 (the DDIM fixed point)."""
    acp = np.asarray(schedule.alphas_cumprod, np.float64)

    def eps(x, t):
        a = float(acp[int(t)])
        return (x - np.sqrt(a) * x0) / np.sqrt(1.0 - a)

    return eps


@pytest.mark.parametrize("solver", ["ddim", "dpmpp"])
def test_samplers_match_jax_with_oracle_denoiser(solver):
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 10, 4)).astype(np.float32)
    noise = rng.normal(size=(3, 10, 4)).astype(np.float32)
    ref_s, got_s = jd.make_schedule(1000), td.make_schedule(1000)
    t_oracle = _oracle(got_s, torch.from_numpy(x0))

    def j_eps(x, t):  # traced timestep: gather the table inside jax
        a = jnp.asarray(ref_s.alphas_cumprod)[t]
        return (x - jnp.sqrt(a) * x0) / jnp.sqrt(1.0 - a)

    got = td.solver_sample(got_s, lambda x, t: t_oracle(x, t).float(), torch.from_numpy(noise), 30,
                           solver=solver).numpy()
    ref = np.asarray(jd.solver_sample(ref_s, j_eps, jnp.asarray(noise), 30, solver=solver))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, x0, atol=1e-5, rtol=0)
    if solver == "ddim":
        got_ddim = td.ddim_sample(got_s, lambda x, t: t_oracle(x, t).float(),
                                  torch.from_numpy(noise), 30).numpy()
        np.testing.assert_allclose(got_ddim, x0, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got_ddim, np.asarray(jd.ddim_sample(
            ref_s, j_eps, jnp.asarray(noise), 30)), atol=1e-5, rtol=0)


def test_ddim_step_matches_jax_with_clip():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5)).astype(np.float32) * 3
    eps = rng.normal(size=(2, 5)).astype(np.float32)
    ref_s, got_s = jd.make_schedule(1000), td.make_schedule(1000)
    for clip in (None, 1.0):
        ref = jd.ddim_step(ref_s, jnp.asarray(eps), 500, 467, jnp.asarray(x), clip_x0=clip)
        got = td.ddim_step(got_s, torch.from_numpy(eps), 500, 467, torch.from_numpy(x), clip_x0=clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
