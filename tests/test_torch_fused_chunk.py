"""Plain version of the port's FusedChunkSampler (the CPU path of
ops/fused_chunk.py) against the JAX FusedChunkSampler in interpret mode,
DDIM and DPM-Solver++(2M), float32, at 4 heads x 16 and 2 heads x 64.
Tolerance 1e-4 absolute: float32
summation order through a 4-step chunk, where 1/sqrt(abar) amplifies the
per-pass eps differences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.diffusion import parse_solver as jax_parse_solver
from soccerdiffusion_tpu.diffusion import solver_timesteps as jax_solver_timesteps
from soccerdiffusion_tpu.ops.fused_chunk import FusedChunkSampler as JaxFusedChunk
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from tests.test_torch_jax_params import SMALL, SMALL_HD64, build_pair, to_jax, to_torch


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


def test_unported_options_raise():
    _, _, model, _, _ = build_pair(SMALL, b=2)
    for kw in ({"group_robots": 2}, {"context_kv_quant": "int8"}, {"cross_orientation": "qstat"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FusedChunkSampler(model, **kw)
