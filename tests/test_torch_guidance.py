"""Classifier-free guidance and modality dropout in the port against the JAX
package, float32 on the CPU:

  * ``null_modalities`` for every modality and "all", 4-dim and 5-dim
    rotations, ``image_u8`` and ``image_data`` batches: equal bit for bit;
  * ``apply_dropout_masks`` under the masks JAX's ``dropout_modalities``
    draws (``split(key, 5)``, ``bernoulli``): equal bit for bit;
  * ``parse_guidance_spec`` (the same results, the same ``ValueError``
    text) and ``inactive_guidance_modalities``;
  * ``make_chunk_sampler`` unguided, guided, distilled and DPM-Solver++
    against the JAX ``sample_fn`` on the same noise (2e-5 of the chunk's
    scale, max |chunk| and at least 1: float32 summation order over 3
    steps; the random model's guided chunks reach |20|);
  * a guided ``RolloutEngine`` over two closed-loop periods against the JAX
    engine (1e-3, as tests/test_torch_rollout.py), and the JAX engine's
    refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.data import pipeline as jax_pipeline
from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.inference import RolloutEngine as JaxEngine
from soccerdiffusion_tpu.inference.sampler import make_chunk_sampler as jax_make_chunk_sampler
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.data import pipeline
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.inference.sampler import make_chunk_sampler
from tests.test_torch_jax_params import SMALL, build_pair, port_config, to_jax, to_torch
from tests.test_torch_rollout import jax_noise

B, STEPS = 3, 3
# a small ViT config with its layers unfused (the guidance path is the
# model's own): 32 px frames in 16 patches of 8, width 64, depth 2
VIT = ModelConfig(**{**SMALL.__dict__, "trajectory_prediction_length": 10, "use_images": True,
                     "image_encoder_type": "vit", "image_resolution": 32, "vit_patch_size": 8,
                     "vit_width": 64, "vit_depth": 2, "image_context_length": 4,
                     "image_use_final_avgpool": True})
NAMES = list(pipeline.MODALITY_KEYS) + ["all"]


def modality_batch(rot_dim, image_key, b=4, seed=0, vision_u=False):
    """A numpy batch with every modality: the joint histories, the IMU in
    ``rot_dim`` dims, frames as ``image_u8`` (with ``image_valid``) or
    ``image_data``, the game state and the target chunk."""
    rng = np.random.default_rng(seed)
    batch = {
        "joint_command": rng.uniform(0, 6.28, (b, 5, 6)).astype(np.float32),
        "joint_command_history": rng.uniform(0, 6.28, (b, 12, 6)).astype(np.float32),
        "joint_state": rng.uniform(0, 6.28, (b, 12, 6)).astype(np.float32),
        "rotation": rng.normal(size=(b, 12, rot_dim)).astype(np.float32),
        "game_state": rng.integers(0, 3, (b,)).astype(np.int32),
    }
    if image_key == "image_u8":
        batch["image_u8"] = rng.integers(0, 256, (b, 4, 8, 8, 3), dtype=np.uint8)
        batch["image_valid"] = np.ones((b, 4), np.float32)
    else:
        batch["image_data"] = rng.normal(size=(b, 4, 8, 8, 3)).astype(np.float32)
    if vision_u:
        batch["vision_u"] = rng.normal(size=(b,)).astype(np.float32)
    return batch


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape and np.array_equal(g, w), k


@pytest.mark.parametrize("image_key", ["image_u8", "image_data"])
@pytest.mark.parametrize("rot_dim", [4, 5])
@pytest.mark.parametrize("name", NAMES)
def test_null_modalities_matches_jax(name, rot_dim, image_key):
    batch = modality_batch(rot_dim, image_key)
    want = jax_pipeline.null_modalities(to_jax(batch), name)
    assert_same_batch(pipeline.null_modalities(to_torch(batch), name), want)


def test_null_modalities_refuses_like_jax():
    batch = {"image_tokens": np.zeros((2, 4, 8), np.float32)}
    for mod in ("image", "all"):
        with pytest.raises(ValueError) as want:
            jax_pipeline.null_modalities(to_jax(batch), mod)
        with pytest.raises(ValueError) as got:
            pipeline.null_modalities(to_torch(batch), mod)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_pipeline.null_modalities({}, ("camera",))
    with pytest.raises(ValueError) as got:
        pipeline.null_modalities({}, ("camera",))
    assert str(got.value) == str(want.value)


def jax_dropout_masks(rng, p, b):
    """The five masks JAX's dropout_modalities draws from ``rng``."""
    return np.stack([np.asarray(jax.random.bernoulli(k, p, (b,)))
                     for k in jax.random.split(rng, 5)])


@pytest.mark.parametrize("vision_u", [False, True])
@pytest.mark.parametrize("image_key", ["image_u8", "image_data"])
@pytest.mark.parametrize("rot_dim", [4, 5])
def test_dropout_under_jax_masks_matches_jax(rot_dim, image_key, vision_u):
    batch = modality_batch(rot_dim, image_key, b=16, seed=rot_dim, vision_u=vision_u)
    rng = jax.random.fold_in(jax.random.key(3), rot_dim)
    want = jax_pipeline.dropout_modalities(to_jax(batch), rng, 0.4)
    masks = jax_dropout_masks(rng, 0.4, 16)
    assert masks.any() and not masks.all()
    assert_same_batch(pipeline.apply_dropout_masks(to_torch(batch), torch.from_numpy(masks)), want)


def test_dropout_draw_rate_and_zero_probability():
    batch = to_torch(modality_batch(4, "image_data", b=4))
    assert pipeline.dropout_modalities(batch, 0.0, torch.Generator()) is batch
    masks = pipeline.draw_dropout_masks(20000, 0.25, torch.Generator().manual_seed(0))
    assert masks.shape == (5, 20000) and masks.dtype == torch.bool
    assert abs(masks.float().mean().item() - 0.25) < 0.01


@pytest.mark.parametrize("spec", ["2.0@image", "3", "1.5@image,imu", "2@all",
                                  "0.5@game_state", "4.0@action_history,joint_states"])
def test_parse_guidance_spec_matches_jax(spec):
    assert pipeline.parse_guidance_spec(spec) == jax_pipeline.parse_guidance_spec(spec)


@pytest.mark.parametrize("spec", ["x@image", "2.0@camera", "2.0@image,bogus", "@image"])
def test_parse_guidance_spec_refuses_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_pipeline.parse_guidance_spec(spec)
    with pytest.raises(ValueError) as got:
        pipeline.parse_guidance_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mods", [("image",), ("game_state", "imu"), ("all",), ("action_history",)])
@pytest.mark.parametrize("cfg", [SMALL, VIT, dataclasses.replace(VIT, use_gamestate=False)],
                         ids=["small", "vit", "vit_no_gs"])
def test_inactive_guidance_modalities_matches_jax(cfg, mods):
    assert (pipeline.inactive_guidance_modalities(port_config(cfg), mods)
            == jax_pipeline.inactive_guidance_modalities(cfg, mods))


SAMPLERS = {
    "ddim": (SMALL, dict()),
    "dpmpp": (SMALL, dict(solver="dpmpp")),
    "distilled": (SMALL, dict(distilled=True)),
    "guided": (SMALL, dict(guidance_scale=2.0, guidance_null=("action_history",))),
    "guided_dpmpp": (SMALL, dict(guidance_scale=2.0, guidance_null=("imu", "game_state"),
                                 solver="dpmpp")),
    "guided_image": (VIT, dict(guidance_scale=3.0, guidance_null=("image",))),
}


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_chunk_sampler_matches_jax(case):
    cfg, kw = SAMPLERS[case]
    jmodel, variables, model, batch, _ = build_pair(cfg, b=B)
    norm = np.linspace(0.5, 1.5, cfg.num_joints).astype(np.float32)
    jnorm = JaxNormalizer(mean=jnp.asarray(norm), std=jnp.asarray(norm))
    rng = jax.random.key(11)
    want = jax_make_chunk_sampler(jmodel, jax_make_schedule(100), jnorm, STEPS, jit=False,
                                  **kw)(variables, to_jax(batch), rng)
    noise = np.asarray(jax.random.normal(
        rng, (B, cfg.trajectory_prediction_length, cfg.num_joints), dtype=jnp.float32))
    sample = make_chunk_sampler(model, make_schedule(100),
                                Normalizer(mean=torch.from_numpy(norm), std=torch.from_numpy(norm)),
                                STEPS, **kw)
    got = sample(to_torch(batch), torch.from_numpy(noise.copy()))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * max(1.0, np.abs(want).max()), rtol=0)


def test_chunk_sampler_refuses_guided_distilled_like_jax():
    jmodel, _, model, _, _ = build_pair(SMALL, b=B)
    with pytest.raises(ValueError, match="not a score prediction"):
        jax_make_chunk_sampler(jmodel, jax_make_schedule(100), JaxNormalizer.identity(6),
                               distilled=True, guidance_scale=2.0)
    with pytest.raises(ValueError, match="not a score prediction"):
        make_chunk_sampler(model, make_schedule(100), Normalizer.identity(6), distilled=True,
                           guidance_scale=2.0)


ENGINES = {
    "action_history": (SMALL, ("action_history",), {}),
    "image_raw_frames": (VIT, ("image",), dict(cache_image_tokens=False)),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_guided_rollout_matches_jax(case):
    """Two closed-loop periods of guided 3-step DDIM (the plain sampler, one
    doubled-batch pass a step), the JAX engine's noise handed to the port."""
    cfg, null, kw = ENGINES[case]
    jmodel, variables, model, _, _ = build_pair(cfg, b=B)
    args = (make_schedule(100), Normalizer.identity(cfg.num_joints))
    j_engine = JaxEngine(jmodel, jax_make_schedule(100), JaxNormalizer.identity(cfg.num_joints),
                         num_inference_steps=STEPS, guidance_scale=2.5, guidance_null=null, **kw)
    key = jax.random.key(7)
    _, ref = j_engine.make_rollout_fn(2, jit=False)(variables, j_engine.init(B, key))
    engine = RolloutEngine(model, *args, num_inference_steps=STEPS, guidance_scale=2.5,
                           guidance_null=null, device="cpu", **kw)
    unguided = RolloutEngine(model, *args, num_inference_steps=STEPS, device="cpu", **kw)
    carry = engine.init(B, torch.Generator().manual_seed(0))
    chunks, plain = [], []
    for noise in jax_noise(cfg, key, 2, B):
        plain.append(unguided.replan_period(carry, torch.from_numpy(noise))[1])
        carry, executed = engine.replan_period(carry, torch.from_numpy(noise))
        chunks.append(executed)
    got = torch.stack(chunks).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-3, rtol=0)
    assert np.abs(got - torch.stack(plain).numpy()).max() > 1e-2  # guidance changed the chunk


@pytest.mark.parametrize("cfg,kw,match", [
    (SMALL, dict(distilled=True), "fused=False, distilled=False"),
    (SMALL, dict(fused=True), "fused=False, distilled=False"),
    (SMALL, dict(fused="chunk"), "fused=False, distilled=False"),
    (VIT, dict(guidance_null=("image",)), "cache_image_tokens=False"),
    (VIT, dict(guidance_null=("all",)), "cache_image_tokens=False"),
], ids=["distilled", "fused_step", "fused_chunk", "image_vs_cache", "all_vs_cache"])
def test_engine_refuses_like_jax(cfg, kw, match):
    jmodel, _, model, _, _ = build_pair(cfg, b=B)
    kw = {"guidance_null": ("action_history",), **kw}
    with pytest.raises(ValueError, match=match):
        JaxEngine(jmodel, jax_make_schedule(100), JaxNormalizer.identity(6), guidance_scale=2.0,
                  **kw)
    with pytest.raises(ValueError, match=match):
        RolloutEngine(model, make_schedule(100), Normalizer.identity(6), guidance_scale=2.0,
                      device="cpu", **kw)


def test_engine_warns_on_a_modality_the_config_lacks(caplog):
    _, _, model, _, _ = build_pair(SMALL, b=B)
    with caplog.at_level("WARNING", logger="soccerdiffusion_tpu_torch"):
        RolloutEngine(model, make_schedule(100), Normalizer.identity(6), guidance_scale=2.0,
                      guidance_null=("image",), device="cpu")
    assert "no-op" in caplog.text and "image" in caplog.text
    with pytest.raises(ValueError, match="unknown modality"):
        RolloutEngine(model, make_schedule(100), Normalizer.identity(6), guidance_scale=2.0,
                      guidance_null=("camera",), device="cpu")
