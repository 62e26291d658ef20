"""The whole slice: the port's RolloutEngine against the JAX RolloutEngine
over 2 replan periods, float32, with the JAX engine's own noise (derived as
its replan_period does) handed to the port.

The port's fused paths run their plain versions here (CPU tensors); the
JAX fused paths run the Pallas kernels in interpret mode. Tolerance 1e-3
absolute on chunks in [0, 2 pi): float32 summation order through 2 closed-loop
periods, where the first period's differences re-enter as context.

Every sampler path's period, profiled on the CPU, opens the engine's three
stage spans in order (``utils/profiling.py:span``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.inference import RolloutEngine as JaxEngine
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
from tests.test_torch_jax_params import SMALL, build_pair, port_config
from tests.test_torch_profiling import ROLLOUT_STAGES, assert_stages, profiled

B, STEPS, PERIODS = 4, 3, 2


def jax_noise(cfg, key, periods, b=B):
    """The per-period chunk noise of the JAX engine's replan_period."""
    out = []
    for _ in range(periods):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(
            sub, (b, cfg.trajectory_prediction_length, cfg.num_joints), dtype=jnp.float32)))
    return out


def run_pair(jax_kw, port_kw, replan_every=None, solver="ddim"):
    jmodel, variables, model, _, _ = build_pair(SMALL, b=B)
    j_engine = JaxEngine(jmodel, jax_make_schedule(100), JaxNormalizer.identity(SMALL.num_joints),
                         num_inference_steps=STEPS, replan_every=replan_every, solver=solver,
                         **jax_kw)
    key = jax.random.key(7)
    _, ref = j_engine.make_rollout_fn(PERIODS, jit=False)(variables, j_engine.init(B, key))
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(SMALL.num_joints),
                           num_inference_steps=STEPS, replan_every=replan_every, solver=solver,
                           device="cpu", **port_kw)
    carry = engine.init(B, torch.Generator().manual_seed(0))
    chunks = []
    for noise in jax_noise(SMALL, key, PERIODS):
        carry, executed = engine.replan_period(carry, torch.from_numpy(noise))
        chunks.append(executed)
    return np.asarray(ref), torch.stack(chunks).numpy(), carry


def test_unfused_rollout_matches_jax():
    ref, got, carry = run_pair({}, {})
    assert got.shape == (PERIODS, B, SMALL.trajectory_prediction_length, SMALL.num_joints)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert carry.controller.joint_command_history.shape == (B, SMALL.action_context_length,
                                                            SMALL.num_joints)


@pytest.mark.parametrize("solver,replan_every", [("ddim", None), ("dpmpp", 2)])
def test_fused_chunk_rollout_matches_jax_kernels(solver, replan_every):
    """The serving path: fused encoder + whole-chunk sampler."""
    enc0, chunk0 = FusedContextEncoder.launches, FusedChunkSampler.launches
    ref, got, _ = run_pair(
        dict(fused="chunk", fused_encoder="interpret", fused_interpret=True, fused_block_robots=2,
             fused_encoder_block_robots=2),
        dict(fused="chunk", fused_encoder=True), replan_every=replan_every, solver=solver)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    # CPU tensors take the plain versions
    assert (FusedContextEncoder.launches, FusedChunkSampler.launches) == (enc0, chunk0)


@pytest.mark.parametrize("port_kw", [dict(fused="step"), dict(distilled=True, fused=True),
                                     dict(distilled=True)])
def test_other_sampler_paths_match_unfused_jax(port_kw):
    """The per-step fused denoiser and the distilled student against the
    JAX engine's unfused path for the same sampler."""
    jax_kw = dict(distilled=True) if port_kw.get("distilled") else {}
    ref, got, _ = run_pair(jax_kw, port_kw)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_own_generator_draws_and_rollout_fn():
    _, _, model, _, _ = build_pair(SMALL, b=B)
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(SMALL.num_joints),
                           num_inference_steps=STEPS, fused="chunk", fused_encoder=True,
                           device="cpu")
    run = engine.make_rollout_fn(3)
    _, a = run(engine.init(B, torch.Generator().manual_seed(3)))
    _, b = run(engine.init(B, torch.Generator().manual_seed(3)))
    assert a.shape == (3, B, SMALL.trajectory_prediction_length, SMALL.num_joints)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # same seed, same rollout


TINY_CAMERA = dict(use_images=True, hidden_dim=64, image_resolution=32, vit_patch_size=8,
                   vit_width=64, vit_depth=1, image_encoder_type="vit", image_context_length=2,
                   vit_fused_block=True)
PROPRIO, CAMERA = port_config(SMALL), port_config(SMALL, **TINY_CAMERA)
SAMPLER_PATHS = {
    "chunk": (PROPRIO, dict(fused="chunk", fused_encoder=True)),
    "distilled-fused": (PROPRIO, dict(distilled=True, fused=True)),
    "distilled": (PROPRIO, dict(distilled=True)),
    "step": (PROPRIO, dict(fused="step")),
    "plain": (PROPRIO, {}),
    "guided": (PROPRIO, dict(guidance_scale=2.0, guidance_null=("imu",))),
    "camera-cached": (CAMERA, dict(fused="chunk")),
}


@pytest.mark.parametrize("path", list(SAMPLER_PATHS))
def test_period_opens_its_stage_spans(path):
    """A profiled replan period of every sampler path holds encode, sample
    and feedback as top-level spans in that order; the noise the engine draws
    itself lies outside them, the camera config's frame tokens inside
    feedback."""
    cfg, kw = SAMPLER_PATHS[path]
    engine = RolloutEngine(DiffusionPolicy(cfg), make_schedule(100), Normalizer.identity(cfg.num_joints),
                           num_inference_steps=STEPS, device="cpu", **kw)
    carry = engine.init(B, torch.Generator().manual_seed(0))
    prof = profiled(lambda: engine.replan_period(carry))
    encode, sample, feedback = assert_stages(prof, ROLLOUT_STAGES)
    draws = [e for e in prof.events() if e.name == "aten::randn"]
    assert draws and all(e.cpu_parent is None for e in draws)
    assert draws[0].time_range.end <= encode.time_range.start
    # the stub camera's frames and the image encoder's blocks run in feedback
    children = {c.name for c in feedback.cpu_children}
    assert ({"aten::linspace", "aten::layer_norm"} <= children) == cfg.use_images
