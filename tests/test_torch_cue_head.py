"""The train step with the aux cue head against the JAX package, float32
on the CPU: ``aux_cue_weight`` 0.1 on a tiny ViT config (the "vision"
dummy task's ``vision_u`` labels, one marked invalid), the ViT's fused block
off and on (the JAX kernel in interpret mode), against the JAX
``make_train_step`` fed its own t and noise: the loss, ``aux_cue_loss`` and
``grad_norm`` within 1e-4 relative, the first step's gradients within 1e-4,
the parameters within 1e-5 after each of 3 AdamW steps (entries whose
gradient is at float32 noise level within AdamW's 2 lr a step, as in
tests/test_torch_distill.py). The other training options of the slice are
in tests/test_torch_train_options.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.data import dataset as jds
from soccerdiffusion_tpu.data import dummy as jdummy
from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import ddim as jddim
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.training.trainer import TrainState as JaxTrainState
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu.training.trainer import make_train_step as jax_make_train_step
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils import load_jax_params
from tests.test_torch_distill import LR, TOTAL, assert_params
from tests.test_torch_jax_params import port_config, to_jax, to_torch
from tests.test_torch_training import grads_as_model

B, STEPS, SEED, WEIGHT = 4, 3, 9, 0.1
CUE = ModelConfig(
    num_joints=6, hidden_dim=64, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=12, imu_context_length=12, use_images=True,
    image_encoder_type="vit", image_resolution=16, image_context_length=2, vit_patch_size=8,
    vit_width=64, vit_depth=1, num_image_sequence_encoder_layers=1,
    num_action_history_encoder_layers=1, num_imu_encoder_layers=1, joint_state_encoder_layers=1,
    num_decoder_layers=1, aux_cue_head=True, attention_impl="xla")


def vision_batch(cfg):
    """A shuffled batch of the "vision" dummy task's windows (float frames,
    vision_u labels), the first label marked invalid, as modality dropout
    marks those of the windows whose camera it drops."""
    kw = dict(num_recordings=2, num_samples=40, num_joints=cfg.num_joints,
              image_size=cfg.image_resolution, seed=4, task="vision")
    ds = jds.WindowedDataset.from_dummy(jdummy.generate_dummy_arrays(**kw), cfg)
    batch = next(ds.batches(B, seed=2))
    batch["vision_u_valid"][0] = 0.0
    return batch


@pytest.mark.parametrize("fused", [False, True], ids=["vit_unfused", "vit_fused_block"])
def test_cue_head_train_step_matches_jax(fused):
    cfg = ModelConfig(**{**CUE.__dict__, "vit_fused_block": fused})
    batch = vision_batch(cfg)
    jmodel = JaxPolicy(cfg)
    shape = batch["joint_command"].shape
    variables = jmodel.init(jax.random.key(SEED), to_jax(batch), jnp.zeros(shape),
                            jnp.zeros((B,), jnp.int32), method=jmodel.forward_with_cue)
    params = jax.tree.map(np.asarray, variables["params"])
    assert "cue_head" in params
    model = load_jax_params(DiffusionPolicy(port_config(cfg)), params)
    jschedule = jax_make_schedule(100)
    jopt = jax_make_optimizer(LR, TOTAL, weight_decay=1e-2)
    jstep = jax_make_train_step(jmodel, jschedule, jopt, JaxNormalizer.identity(cfg.num_joints),
                                donate=False, aux_cue_weight=WEIGHT)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=jopt.init(variables["params"]), ema_params={})
    opt = make_optimizer(model, LR, TOTAL, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg.num_joints),
                           aux_cue_weight=WEIGHT)
    noisy = {}
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.key(SEED), i)  # the JAX step's draws
        t_key, noise_key, _ = jax.random.split(key, 3)
        t = np.array(jax.random.randint(t_key, (B,), 0, 100))
        noise = np.array(jax.random.normal(noise_key, shape, jnp.float32))
        if i == 0:
            x_t = jddim.add_noise(jschedule, jnp.asarray(batch["joint_command"]),
                                  jnp.asarray(noise), jnp.asarray(t))

            def loss_fn(prm):
                pred, cue = jmodel.apply({"params": prm}, to_jax(batch), x_t, jnp.asarray(t), True,
                                         method=jmodel.forward_with_cue)
                valid = batch["vision_u_valid"]
                aux = jnp.sum(valid * (cue - batch["vision_u"]) ** 2) / max(valid.sum(), 1.0)
                return jnp.mean((pred - noise) ** 2) + WEIGHT * aux

            want_grads = grads_as_model(model, jax.jit(jax.grad(loss_fn))(jstate.params))
        jstate, jmetrics = jstep(jstate, to_jax(batch), SEED)
        metrics = step.apply(state, to_torch(batch), torch.from_numpy(t), torch.from_numpy(noise))
        for name in ("loss", "aux_cue_loss", "grad_norm"):
            np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]), rtol=1e-4,
                                       err_msg=f"step {i}: {name}")
        if i == 0:
            assert model.cue_head.weight.grad.abs().max() > 0
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want_grads[name].detach().numpy(),
                                           atol=1e-4, rtol=0, err_msg=name)
        assert_params(model, jstate.params, i, noisy, f"cue head, fused={fused}")
