"""Serving the ResNet image configurations (tests/test_torch_image_configs.py's
cuts of default.yaml, sim_scratch.yaml and larger_model.yaml, whose decoder
runs at head_dim 128) on the CPU: 2 closed-loop periods of the port's
RolloutEngine against the JAX engine, float32: 3-step
DDIM through the whole-chunk sampler with the image-token cache and with raw
frames, the distilled student through the fused denoiser. The model is left
in train mode by the caller; the engine serves in eval mode (BatchNorm on
its running statistics, as the JAX engine's train=False applies), restores
the caller's mode and never updates the statistics.

The JAX engine runs its Pallas kernels in interpret mode; the port's run
their plain versions (CPU tensors). Noise is the JAX engine's own.
Tolerance 1e-3 absolute on chunks in [0, 2 pi), as
tests/test_torch_multimodal_rollout.py: float32 summation order through 2
closed-loop periods.
"""

import jax
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.inference import RolloutEngine as JaxEngine
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from tests.test_torch_image_configs import DEFAULT, LARGER, SIM
from tests.test_torch_jax_params import build_pair
from tests.test_torch_rollout import jax_noise

B, PERIODS, CHUNK_TOL = 2, 2, 1e-3


def run_rollout_pair(cfg, cache, distilled):
    jmodel, variables, model, _, _ = build_pair(cfg, b=B)
    jkw = dict(distilled=True, fused=True) if distilled else dict(fused="chunk")
    j_engine = JaxEngine(jmodel, jax_make_schedule(100), JaxNormalizer.identity(cfg.num_joints),
                         num_inference_steps=3, fused_interpret=True, fused_block_robots=B,
                         cache_image_tokens=cache, **jkw)
    key = jax.random.key(5)
    _, ref = j_engine.make_rollout_fn(PERIODS, jit=False)(
        variables, j_engine.init(B, key, variables=variables))
    model.train()  # the engine serves in eval mode whatever the caller's mode
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(cfg.num_joints),
                           num_inference_steps=3, cache_image_tokens=cache, device="cpu", **jkw)
    carry = engine.init(B, torch.Generator().manual_seed(0))
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    chunks = []
    for noise in jax_noise(cfg, key, PERIODS, B):
        carry, executed = engine.replan_period(carry, torch.from_numpy(noise))
        chunks.append(executed)
    assert model.training  # the caller's mode, restored
    for k, v in model.state_dict().items():  # serving never updates the running statistics
        if k in stats:
            torch.testing.assert_close(v, stats[k], atol=0, rtol=0)
    return np.asarray(ref), torch.stack(chunks).numpy()


@pytest.mark.parametrize("cache,distilled", [(True, False), (False, False), (True, True)],
                         ids=["cached-ddim", "raw-ddim", "cached-distilled"])
def test_resnet_rollout_matches_jax(cache, distilled):
    ref, got = run_rollout_pair(DEFAULT, cache, distilled)
    assert got.shape == (PERIODS, B, 10, DEFAULT.num_joints)
    np.testing.assert_allclose(got, ref, atol=CHUNK_TOL, rtol=0)


def test_sim_scratch_rollout_matches_jax():
    ref, got = run_rollout_pair(SIM, True, False)
    np.testing.assert_allclose(got, ref, atol=CHUNK_TOL, rtol=0)


@pytest.mark.parametrize("cache,distilled", [(True, False), (False, False), (True, True)],
                         ids=["cached-ddim", "raw-ddim", "cached-distilled"])
def test_larger_model_rollout_matches_jax(cache, distilled):
    """larger_model.yaml's cut (the decoder at head_dim 128): the chunk
    sampler's and the denoiser's plain versions against the JAX kernels."""
    ref, got = run_rollout_pair(LARGER, cache, distilled)
    assert got.shape == (PERIODS, B, 10, LARGER.num_joints)
    np.testing.assert_allclose(got, ref, atol=CHUNK_TOL, rtol=0)
