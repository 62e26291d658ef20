"""The port's DiffusionPolicy filled from flax params (utils/jax_params.py),
and its unfused forward against the JAX model.

Shared helpers of the tests/test_torch_*.py parity tests live here too:
inputs are made with numpy from a seed and handed to both packages, and
``port_config`` builds the port's own config from a JAX config's fields.
Comparisons are float32; 2e-5 absolute covers float32 summation-order
differences through a few layers at unit-scale activations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu_torch import config as port
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.utils import load_jax_params
from soccerdiffusion_tpu_torch.utils.jax_params import _flatten, random_jax_params

F32_ATOL = 2e-5

SMALL = ModelConfig(
    num_joints=6, hidden_dim=64, trajectory_prediction_length=5,
    action_context_length=12, joint_state_context_length=12, imu_context_length=12,
    use_images=False, use_gamestate=True, num_action_history_encoder_layers=1,
    num_imu_encoder_layers=1, joint_state_encoder_layers=1, num_decoder_layers=2,
    attention_impl="xla",
)


# the decoder at 2 heads x 64, the CUDA decoder kernels' h256 instance
SMALL_HD64 = ModelConfig(**{**SMALL.__dict__, "hidden_dim": 128, "num_decoder_heads": 2})
# the decoder at 2 heads x 128, the head_dim of larger_model.yaml's (the
# kernels' hidden-512 instance, 4 heads x 128)
SMALL_HD128 = ModelConfig(**{**SMALL.__dict__, "hidden_dim": 256, "num_decoder_heads": 2})


def port_config(cfg: ModelConfig, **changes) -> port.ModelConfig:
    """The port's ModelConfig with the JAX config's fields (and ``changes``)."""
    return port.ModelConfig(**{**dataclasses.asdict(cfg), **changes})


def make_batch(cfg, b, rng):
    """A numpy controller-style batch for ``cfg``: [0, 2 pi) joints, unit IMU
    (and unit-normal NHWC frames for an image config)."""
    batch = {
        "joint_command_history": rng.uniform(0, 2 * np.pi, (b, cfg.action_context_length,
                                                            cfg.num_joints)).astype(np.float32),
        "rotation": rng.normal(size=(b, cfg.imu_context_length, cfg.imu_input_dim)).astype(np.float32),
        "joint_state": rng.uniform(0, 2 * np.pi, (b, cfg.joint_state_context_length,
                                                  cfg.num_joints)).astype(np.float32),
        "game_state": rng.integers(0, 4, (b,)).astype(np.int32),
    }
    if cfg.use_images:
        res = cfg.image_resolution
        batch["image_data"] = rng.standard_normal(
            (b, cfg.image_context_length, res, res, 3)).astype(np.float32)
    return batch


def build_pair(cfg, b=4, seed=0):
    """(jax model, jax variables, port model with the same params and
    batch_stats, numpy batch, rng)."""
    rng = np.random.default_rng(seed)
    batch = make_batch(cfg, b, rng)
    jmodel = JaxPolicy(cfg)
    variables = jmodel.init(
        jax.random.key(seed), to_jax(batch),
        jnp.zeros((b, cfg.trajectory_prediction_length, cfg.num_joints)),
        jnp.zeros((b,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    model = load_jax_params(DiffusionPolicy(port_config(cfg)), params, stats)
    return jmodel, variables, model, batch, rng


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_every_leaf_used_once():
    _, variables, model, _, _ = build_pair(SMALL)
    leaves = _flatten(jax.tree.map(np.asarray, variables["params"]))
    assert len(leaves) == sum(1 for _ in model.parameters())


def test_random_params_have_the_flax_layout():
    """random_jax_params (the chip smoke's init) matches the tree JAX builds."""
    _, variables, model, _, _ = build_pair(SMALL)
    want = {k: v.shape for k, v in _flatten(jax.tree.map(np.asarray, variables["params"])).items()}
    tree, stats = random_jax_params(model, seed=3)
    assert {k: v.shape for k, v in _flatten(tree).items()} == want and stats == {}
    load_jax_params(DiffusionPolicy(port_config(SMALL)), tree, stats)


def test_wrong_shape_raises():
    _, variables, _, _, _ = build_pair(SMALL)
    params = jax.tree.map(np.asarray, variables["params"])
    q = params["diffusion_action_generator"]["decoder"]["layer_0"]["self_attn"]["q_proj"]
    q["kernel"] = np.zeros((64, 32), np.float32)
    with pytest.raises(ValueError, match="q_proj/kernel"):
        load_jax_params(DiffusionPolicy(port_config(SMALL)), params)


def test_missing_and_leftover_leaves_raise():
    _, variables, _, _, _ = build_pair(SMALL)
    params = jax.tree.map(np.asarray, variables["params"])
    params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra/kernel"):
        load_jax_params(DiffusionPolicy(port_config(SMALL)), params)
    del params["extra"]
    del params["step_encoding"]
    with pytest.raises(KeyError, match="step_encoding/token"):
        load_jax_params(DiffusionPolicy(port_config(SMALL)), params)


@pytest.mark.parametrize("patch", [1, 2])
def test_unfused_forward_matches_jax(patch):
    cfg = ModelConfig(**{**SMALL.__dict__, "encoder_patch_size": patch})
    jmodel, variables, model, batch, rng = build_pair(cfg, b=3)
    noisy = rng.standard_normal((3, cfg.trajectory_prediction_length, cfg.num_joints)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    ref_ctx = jmodel.apply(variables, to_jax(batch), False, method=jmodel.encode_context)
    ref = jmodel.apply(variables, to_jax(batch), jnp.asarray(noisy), jnp.asarray(t), False)
    with torch.no_grad():
        ctx = model.encode_context(to_torch(batch))
        got = model(to_torch(batch), torch.from_numpy(noisy), torch.from_numpy(t))
        kv = model.precompute_context_kv(ctx)
        got_kv = model.denoise_with_kv(kv, torch.from_numpy(noisy), torch.from_numpy(t))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0)


def test_non_xla_attention_raises():
    # "ring" builds since the parallel/ slice (tests/test_torch_parallel_models.py)
    ring = DiffusionPolicy(port_config(SMALL, attention_impl="ring"))
    assert sum(1 for _ in ring.parameters()) == sum(1 for _ in DiffusionPolicy(
        port_config(SMALL)).parameters())
    # ResNet18, the default encoder, builds and takes the JAX params and batch_stats
    cfg = ModelConfig(**{**SMALL.__dict__, "use_images": True, "image_resolution": 64,
                         "image_context_length": 2})
    _, variables, model, _, _ = build_pair(cfg, b=2)
    assert variables["batch_stats"] and len(_flatten(variables["params"])) == sum(
        1 for _ in model.parameters())
    with pytest.raises(KeyError, match="batch_stats"):
        load_jax_params(DiffusionPolicy(port_config(cfg)), variables["params"])
    with pytest.raises(TypeError, match="soccerdiffusion_tpu_torch.config.ModelConfig"):
        DiffusionPolicy(SMALL)  # the JAX package's config
