"""The flagship training slice as a whole, on the CPU: three AdamW steps of a
tiny flagship-shaped model (the fused ViT with quick GELU over
pre-patchified frames, fused encoder stacks, fused decoder layers) from
packed uint8 batches, through the port's trainer and through the JAX
package's model + optax from the same parameters (load_jax_params), batches,
timesteps and noise. The JAX kernels run in interpret mode, the port's plain
versions on CPU tensors; float32.

Parameters within 1e-5 after each step (as tests/test_torch_training.py);
the key biases, whose gradient is zero in exact arithmetic, within 2 lr per
step (AdamW normalises float32 noise to a step of either sign).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.data.dataset import WindowedDataset as JaxWindowed
from soccerdiffusion_tpu.data.dummy import generate_dummy_arrays as jax_dummy
from soccerdiffusion_tpu.data.packed import PackedDataset as JaxPacked
from soccerdiffusion_tpu.diffusion import add_noise as jax_add_noise
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.config import Config, TrainConfig
from soccerdiffusion_tpu_torch.training import train
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils import load_jax_params

from tests.test_torch_jax_params import port_config, to_jax, to_torch
from tests.test_torch_training import grads_as_model

FLAG = ModelConfig(
    num_joints=6, hidden_dim=64, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=12, imu_context_length=12, use_images=True,
    image_encoder_type="vit", image_resolution=16, image_context_length=2, vit_patch_size=8,
    vit_width=64, vit_depth=1, num_image_sequence_encoder_layers=1,
    num_action_history_encoder_layers=1, num_imu_encoder_layers=1, joint_state_encoder_layers=1,
    num_decoder_layers=1, vit_fused_block=True, vit_fused_gelu="quick",
    encoder_fused_stack=True, decoder_fused_block=True, attention_impl="xla")
B, STEPS = 2, 3


def packed_batches(cfg):
    """The first STEPS shuffled packed batches (pre-patchified uint8 frames)
    of the "vision" dummy task for ``cfg``, from the JAX package and from the
    port."""
    kw = dict(num_recordings=2, num_samples=40, num_joints=cfg.num_joints,
              image_size=cfg.image_resolution, seed=2, task="vision")
    jp = JaxPacked.from_windowed(JaxWindowed.from_dummy(jax_dummy(**kw), cfg))
    pp = PackedDataset.from_windowed(WindowedDataset.from_dummy(generate_dummy_arrays(**kw),
                                                                port_config(cfg)))
    for ds in (jp, pp):
        ds.prepatchify_images(cfg.vit_patch_size)
    return [list(ds.batches(B, seed=1))[:STEPS] for ds in (jp, pp)]


def test_three_flagship_steps_match_the_jax_trainer():
    three_steps_match_the_jax_trainer(FLAG)


def three_steps_match_the_jax_trainer(cfg):
    """STEPS AdamW steps of ``cfg`` on the port's trainer against the JAX
    model + optax, parameters compared after each step."""
    jbatches, pbatches = packed_batches(cfg)
    for j, p in zip(jbatches, pbatches):
        assert j.keys() == p.keys() and "image_u8" in p
        for k in j:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    rng = np.random.default_rng(0)
    jmodel = JaxPolicy(cfg)
    batch0 = jbatches[0]
    variables = jmodel.init(jax.random.key(0), to_jax(batch0),
                            jnp.zeros(batch0["joint_command"].shape), jnp.zeros((B,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    model = load_jax_params(DiffusionPolicy(port_config(cfg)), params)
    lr, total = 1e-3, 10
    jschedule = jax_make_schedule(100)

    @jax.jit
    def jax_grads(params, batch, t, noise):  # the JAX trainer's loss, traced once
        noisy = jax_add_noise(jschedule, batch["joint_command"], noise, t)
        pred = lambda p: jmodel.apply({"params": p}, batch, noisy, t, True)
        return jax.grad(lambda p: jnp.mean(jnp.square(pred(p).astype(jnp.float32) - noise)))(params)

    jopt = jax_make_optimizer(lr, total, weight_decay=1e-2, grad_clip_norm=0.5)
    opt_state = jopt.init(params)
    opt = make_optimizer(model, lr, total, weight_decay=1e-2, grad_clip_norm=0.5)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg.num_joints))
    for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
        t = rng.integers(0, 100, (B,)).astype(np.int32)
        noise = rng.standard_normal(jb["joint_command"].shape).astype(np.float32)
        grads = jax_grads(params, to_jax(jb), jnp.asarray(t), jnp.asarray(noise))
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = step.apply(state, to_torch(pb), torch.from_numpy(t), torch.from_numpy(noise))
        assert np.isfinite(metrics["loss"].item())
        want = grads_as_model(model, params)
        noise_bound = 2 * sum(lr_at_step(lr, total, k) for k in range(i + 1))
        for name, p in model.named_parameters():
            tol = noise_bound if name.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), atol=tol,
                                       rtol=0, err_msg=f"step {i}: {name}")
    assert metrics["grad_norms_by_layer"]["image_sequence_encoder"].item() > 0


def test_flax_init_covers_every_flagship_leaf():
    """flax_init_params fills every parameter of vit_flagship.yaml's model:
    the patch kernel LeCun-normal over its P*P*C inputs, the patch bias zero."""
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params

    cfg = Config.from_yaml(str(Path(train.__file__).parent / "configs" / "vit_flagship.yaml"))
    model = DiffusionPolicy(cfg.model)
    load_jax_params(model, flax_init_params(model, 0))
    vit = model.image_sequence_encoder.image_encoder
    assert tuple(vit.patch_kernel.shape) == (28 * 28 * 3, 256)
    std = vit.patch_kernel.std().item()
    assert abs(std - np.sqrt(1.0 / (28 * 28 * 3))) < 0.05 * std
    assert vit.patch_bias.abs().max().item() == 0.0


def test_packed_training_on_the_card_raises_without_one(tmp_path):
    """train(..., device="cuda") with packed flagship-shaped data raises
    where there is no GPU, before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    config = Config(model=port_config(FLAG), train=TrainConfig(batch_size=B))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(config, train.RunOptions(output=str(tmp_path / "ckpt"), packed=True,
                                             epochs=1, device="cuda"))
