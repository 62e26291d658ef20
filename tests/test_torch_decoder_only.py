"""The decoder-only tier (decoder_only.yaml: every context modality off, so
the denoiser conditions on the diffusion step token alone) on the CPU
against the JAX package, at small width (hidden 64, 6 joints, 2 decoder
layers): the empty context and the forward, 2 closed-loop periods of
RolloutEngine against the JAX engine (the plain sampler, the whole-chunk
sampler and the distilled student through the fused denoiser, both at S=0
context tokens: only the step token's key), and 3 AdamW steps against the
JAX trainer (tests/test_torch_image_training.py's comparison, float64
reference).

The port's fused lanes run their kernels' plain versions (CPU tensors).
The JAX package's Pallas chunk sampler and denoiser do not take a context
of 0 tokens (a zero-size max reduction), so the JAX reference of those
lanes is its plain sampler of the same function (fused=False; the
distilled student's one pass at t=0) with the same noise. Tolerances: the forward 1e-4 of its scale (float32); chunks 1e-3
absolute in [0, 2 pi) over 2 periods, as tests/test_torch_rollout.py; the
training steps' tolerances are tests/test_torch_image_training.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.inference import RolloutEngine as JaxEngine
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.inference.controller import (
    init_controller_state,
    make_controller_batch,
)
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.utils import load_jax_params
from tests.test_torch_image_training import three_steps_match_the_jax_trainer
from tests.test_torch_jax_params import SMALL, port_config, to_jax
from tests.test_torch_rollout import jax_noise

B, PERIODS = 3, 2
FWD_TOL, CHUNK_TOL = 1e-4, 1e-3
DECODER_ONLY = ModelConfig(**{**SMALL.__dict__, "use_action_history": False, "use_imu": False,
                              "use_joint_states": False, "use_images": False,
                              "use_gamestate": False, "encoder_patch_size": 10,
                              "trajectory_prediction_length": 10})


def build_pair():
    """(jax model, its variables, the port model with the same params): the
    batch of the decoder-only tier is its target alone."""
    jmodel = JaxPolicy(DECODER_ONLY)
    zeros = jnp.zeros((B, 10, 6))
    variables = jmodel.init(jax.random.key(0), {"joint_command": zeros}, zeros,
                            jnp.zeros((B,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    return jmodel, variables, load_jax_params(DiffusionPolicy(port_config(DECODER_ONLY)), params, {})


def test_empty_context_and_forward_match_jax():
    jmodel, variables, model = build_pair()
    rng = np.random.default_rng(0)
    batch = {"joint_command": np.zeros((B, 10, 6), np.float32)}
    noisy = rng.standard_normal((B, 10, 6)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    ref = jmodel.apply(variables, to_jax(batch), jnp.asarray(noisy), jnp.asarray(t), False)
    with torch.no_grad():
        ctx = model.encode_context({"joint_command": torch.zeros((B, 0, 0))})
        got = model({"joint_command": torch.zeros((B, 10, 6))}, torch.from_numpy(noisy),
                    torch.from_numpy(t))
    assert tuple(ctx.shape) == (B, 0, 64) and ctx.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_TOL * np.abs(ref).max(),
                               rtol=0)
    # the serving batch carries the batch size in a zero-width joint_command
    state = init_controller_state(port_config(DECODER_ONLY), B, device="cpu")
    assert tuple(make_controller_batch(port_config(DECODER_ONLY), state)["joint_command"].shape) \
        == (B, 0, 0)


@pytest.mark.parametrize("kw", [dict(fused=False), dict(fused="chunk"),
                                dict(distilled=True, fused=True)],
                         ids=["plain", "chunk", "distilled"])
def test_decoder_only_rollout_matches_jax(kw):
    jmodel, variables, model = build_pair()
    j_engine = JaxEngine(jmodel, jax_make_schedule(100), JaxNormalizer.identity(6),
                         num_inference_steps=3, distilled=kw.get("distilled", False))
    key = jax.random.key(11)
    _, ref = j_engine.make_rollout_fn(PERIODS, jit=False)(variables, j_engine.init(B, key))
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(6),
                           num_inference_steps=3, device="cpu", **kw)
    carry = engine.init(B, torch.Generator().manual_seed(0))
    chunks = []
    for noise in jax_noise(DECODER_ONLY, key, PERIODS, B):
        carry, executed = engine.replan_period(carry, torch.from_numpy(noise))
        chunks.append(executed)
    got = torch.stack(chunks).numpy()
    assert got.shape == (PERIODS, B, 10, 6)
    np.testing.assert_allclose(got, np.asarray(ref), atol=CHUNK_TOL, rtol=0)


def test_three_decoder_only_steps_match_the_jax_trainer():
    three_steps_match_the_jax_trainer(DECODER_ONLY)
