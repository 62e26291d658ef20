"""Camera-conditioned serving: the port's RolloutEngine against the JAX
RolloutEngine over 2 closed-loop replan periods of a small ViT config
(32 px frames, patch 8, width 64, depth 2, hidden 64, the fused ViT blocks
and encoder stacks on, quick GELU), float32, with the image-token cache and
with raw frames, for 3-step DDIM through the whole-chunk sampler and for the
distilled student through the fused denoiser.

The JAX engine runs its Pallas kernels in interpret mode; the port's run
their plain versions (CPU tensors). Noise is the JAX engine's own, handed
to the port as in tests/test_torch_rollout.py. The 10-tick chunk gives the
stub camera 2 frames per period. Tolerance 1e-3 absolute, as there: float32
summation order through 2 closed-loop periods.
"""

import jax
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
from soccerdiffusion_tpu_torch.ops import fused_chunk, fused_denoise, fused_vit_block
from tests.test_torch_jax_params import SMALL, build_pair
from tests.test_torch_rollout import jax_noise

B, STEPS, PERIODS = 3, 3, 2
VIT = ModelConfig(**{**SMALL.__dict__, "trajectory_prediction_length": 10, "use_images": True,
                     "image_encoder_type": "vit", "image_resolution": 32, "vit_patch_size": 8,
                     "vit_width": 64, "vit_depth": 2, "image_context_length": 4,
                     "image_use_final_avgpool": True, "encoder_fused_stack": True,
                     "vit_fused_block": True, "vit_fused_gelu": "quick"})


def run_pair(cache, distilled):
    jmodel, variables, model, _, _ = build_pair(VIT, b=B)
    jkw = dict(distilled=True, fused=True) if distilled else dict(fused="chunk")
    j_engine = JaxEngine(jmodel, jax_make_schedule(100), JaxNormalizer.identity(VIT.num_joints),
                         num_inference_steps=STEPS, fused_interpret=True, fused_block_robots=B,
                         cache_image_tokens=cache, **jkw)
    key = jax.random.key(5)
    carry0 = j_engine.init(B, key, variables=variables)  # the zero-frame token prefill
    _, ref = j_engine.make_rollout_fn(PERIODS, jit=False)(variables, carry0)
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(VIT.num_joints),
                           num_inference_steps=STEPS, cache_image_tokens=cache, device="cpu",
                           **jkw)
    carry = engine.init(B, torch.Generator().manual_seed(0))
    chunks = []
    for noise in jax_noise(VIT, key, PERIODS, B):
        carry, executed = engine.replan_period(carry, torch.from_numpy(noise))
        chunks.append(executed)
    return np.asarray(ref), torch.stack(chunks).numpy(), carry


@pytest.mark.parametrize("distilled", [False, True])
@pytest.mark.parametrize("cache", [True, False])
def test_multimodal_rollout_matches_jax(cache, distilled):
    counts = (fused_vit_block.forward_kernel.launches, fused_chunk.FusedChunkSampler.launches,
              fused_denoise.FusedDenoiser.launches)
    ref, got, carry = run_pair(cache, distilled)
    assert got.shape == (PERIODS, B, 10, VIT.num_joints)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    ctl = carry.controller
    if cache:
        assert ctl.images is None and ctl.image_tokens.shape == (B, 4, VIT.hidden_dim)
    else:
        assert ctl.image_tokens is None and ctl.images.shape == (B, 4, 32, 32, 3)
    # CPU tensors take the plain versions
    assert counts == (fused_vit_block.forward_kernel.launches,
                      fused_chunk.FusedChunkSampler.launches, fused_denoise.FusedDenoiser.launches)


def test_image_config_checks():
    _, _, model, _, _ = build_pair(VIT, b=B)
    make = lambda **kw: RolloutEngine(model, make_schedule(100), Normalizer.identity(6),
                                      device="cpu", **kw)
    with pytest.raises(ValueError, match="multiple of 5"):
        make(replan_every=3)
    with pytest.raises(ValueError, match="fused_encoder"):
        make(fused="chunk", fused_encoder=True)
    assert make().cache_image_tokens and not make(cache_image_tokens=False).cache_image_tokens
    # without the prefill the token cache starts at zero tokens
    zero = make().init(B, torch.Generator().manual_seed(0), prefill=False).controller.image_tokens
    assert not zero.any()
