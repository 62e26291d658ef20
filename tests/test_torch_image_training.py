"""Training the ResNet image configurations (tests/test_torch_image_configs.py's
cut of default.yaml and of sim_scratch.yaml) on the CPU: 3 AdamW steps
(clipping, EMA, BatchNorm statistics updated in train mode) on the port's
trainer, float32, from packed whole-frame uint8 batches, against the JAX
model + optax from the same init, batches, timesteps and noise: the loss,
every gradient, the parameters and batch_stats after each step.

The reference runs in float64 (jax.enable_x64, every module of the JAX
policy at dtype float64): flax's float32 BatchNorm (the fast variance
E[x^2] - E[x]^2, reduced in float32) gives ResNet gradients up to 20% off
the float64 ones on these batches (measured; the port's float32 gradients
stay within 1e-5 of them), so a float32 JAX trajectory could not hold the
port to a useful bound. The frames are seeded uint8 noise (packed_batches).

Tolerances: the loss 1e-5 relative; batch_stats 1e-4 and each gradient
1e-3 of the tensor's largest magnitude (measured: 2e-6, 3e-6 and 1e-4);
parameters 5e-5 after each step (an AdamW step moves every entry by ~lr,
4e-5 at the first step, whatever its gradient's size, so an entry whose
gradient is at float32 rounding level takes a different fraction of it;
measured 1.4e-5); the key biases, whose gradient is zero in exact
arithmetic, within 2 lr a step, as tests/test_torch_flagship_training.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccerdiffusion_tpu.diffusion import add_noise as jax_add_noise
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import _flatten, load_jax_params, random_jax_params
from tests.test_torch_image_configs import CONFIGS, close, packed_batches
from tests.test_torch_jax_params import make_batch, port_config, to_jax, to_torch

B = 2
LOSS_TOL, STATS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-3, 5e-5


def grads_as_model(model, grads, stats):
    return dict(load_jax_params(copy.deepcopy(model), jax.tree.map(np.asarray, grads),
                                stats).named_parameters())


class JaxPolicy64(JaxPolicy):
    """The JAX DiffusionPolicy computing in float64 (under jax.enable_x64):
    every module of it takes the policy's dtype."""

    @property
    def dtype(self):
        return jnp.float64


def three_steps_match_the_jax_trainer(cfg):
    """STEPS AdamW steps of ``cfg`` (train mode, BatchNorm statistics
    updated) on the port's trainer (float32) against the JAX model + optax
    in float64 from the same float32 init: the loss, every gradient, the
    parameters and batch_stats after each step."""
    jbatches, pbatches = packed_batches(cfg)
    for j, p in zip(jbatches, pbatches):
        assert j.keys() == p.keys()
        for k in j:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    rng = np.random.default_rng(0)
    batch0 = jbatches[0]
    variables = JaxPolicy(cfg).init(jax.random.key(0), to_jax(batch0),
                                    jnp.zeros(batch0["joint_command"].shape),
                                    jnp.zeros((B,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    model = load_jax_params(DiffusionPolicy(port_config(cfg)), params, stats)
    lr, total = 1e-3, 10
    opt = make_optimizer(model, lr, total, weight_decay=1e-2, grad_clip_norm=0.5)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg.num_joints),
                           ema_decay=0.9)
    with jax.enable_x64(True):
        jmodel, jschedule = JaxPolicy64(cfg), jax_make_schedule(100)
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        params, stats = f64(params), f64(stats)

        @jax.jit
        def jax_step(params, stats, batch, t, noise):
            noisy = jax_add_noise(jschedule, batch["joint_command"], noise, t)

            def loss(p):
                pred, mutated = jmodel.apply({"params": p, "batch_stats": stats}, batch, noisy, t,
                                             True, mutable=["batch_stats"])
                return jnp.mean(jnp.square(pred - noise)), mutated

            (value, mutated), grads = jax.value_and_grad(loss, has_aux=True)(params)
            return value, grads, mutated.get("batch_stats", {})

        jopt = jax_make_optimizer(lr, total, weight_decay=1e-2, grad_clip_norm=0.5)
        opt_state = jopt.init(params)
        for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
            t = rng.integers(0, 100, (B,)).astype(np.int32)
            noise = rng.standard_normal(jb["joint_command"].shape).astype(np.float32)
            value, grads, stats = jax_step(params, stats, f64(to_jax(jb)), jnp.asarray(t),
                                           jnp.asarray(noise, jnp.float64))
            clipped, _ = optax.clip_by_global_norm(0.5).update(grads, optax.EmptyState())
            updates, opt_state = jopt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            metrics = step.apply(state, to_torch(pb), torch.from_numpy(t),
                                 torch.from_numpy(noise))
            np.testing.assert_allclose(metrics["loss"].item(), float(value), rtol=LOSS_TOL,
                                       err_msg=f"step {i}: loss")
            np32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
            stats32 = np32(stats)
            want_grads = grads_as_model(model, np32(clipped), stats32)  # the port clips in place
            for name, p in model.named_parameters():
                if name.endswith("k_proj.bias"):
                    continue  # zero in exact arithmetic: float noise in both packages
                close(p.grad.numpy(), want_grads[name].detach().numpy(), GRAD_TOL,
                      f"step {i}: grad {name}")
            want = grads_as_model(model, np32(params), stats32)
            noise_bound = 2 * sum(lr_at_step(lr, total, k) for k in range(i + 1))
            for name, p in model.named_parameters():
                tol = noise_bound if name.endswith("k_proj.bias") else PARAM_TOL
                np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                           atol=tol, rtol=0, err_msg=f"step {i}: {name}")
            buffers = dict(model.named_buffers())
            for path, value in _flatten(stats32).items():
                name = path.replace("/", ".").replace("layer_", "layers.")
                close(buffers[name].numpy(), value, STATS_TOL, f"step {i}: {path}")
    # the EMA covers the parameters only, as the JAX EMA covers params
    assert set(state.ema) == {n for n, _ in model.named_parameters()}
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_three_steps_match_the_jax_trainer(name):
    model = three_steps_match_the_jax_trainer(CONFIGS[name])
    bn = model.image_sequence_encoder.image_encoder.bn1
    assert not torch.equal(bn.var, torch.ones_like(bn.var))  # updated in train mode


def loss_and_grads(model, batch, noisy, t):
    model.train()
    for p in model.parameters():
        p.grad = None
    loss = (model(batch, noisy, t) ** 2).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("knob,value,encoder", [
    ("remat_decoder", True, "resnet18"), ("remat_image_encoder", True, "vit"),
    ("remat_image_encoder", True, "swin_transformer_tiny")])
def test_remat_knobs_give_the_same_step(knob, value, encoder):
    """remat_decoder (each unfused decoder layer recomputed in the backward)
    and remat_image_encoder True on the ViT (each unfused block) and Swin
    (the whole per-frame forward): the same loss, gradients and running
    statistics as without, bit for bit (the same CPU ops rerun in order)."""
    res = 224 if encoder.startswith("swin") else 64
    cfg = port_config(CONFIGS["default"], image_encoder_type=encoder, image_resolution=res,
                      image_context_length=1, vit_patch_size=16, vit_width=32, vit_depth=2)
    base = DiffusionPolicy(cfg)
    load_jax_params(base, *random_jax_params(base, seed=5))
    remat = DiffusionPolicy(port_config(CONFIGS["default"], image_encoder_type=encoder,
                                        image_resolution=res, image_context_length=1,
                                        vit_patch_size=16, vit_width=32, vit_depth=2,
                                        **{knob: value}))
    remat.load_state_dict(base.state_dict())
    rng = np.random.default_rng(5)
    batch = to_torch(make_batch(CONFIGS["default"], 1, rng) | {
        "image_data": rng.standard_normal((1, 1, res, res, 3)).astype(np.float32)})
    noisy = torch.from_numpy(rng.standard_normal((1, 10, 6)).astype(np.float32))
    t = torch.tensor([7])
    want_loss, want = loss_and_grads(base, batch, noisy, t)
    got_loss, got = loss_and_grads(remat, batch, noisy, t)
    assert torch.equal(got_loss, want_loss) and got.keys() == want.keys()
    for name, g in got.items():
        torch.testing.assert_close(g, want[name], atol=0, rtol=0, msg=name)
    for (name, a), b in zip(base.named_buffers(), remat.buffers()):
        torch.testing.assert_close(b, a, atol=0, rtol=0, msg=name)
