"""The port's training step (training/trainer.py) against the JAX package,
on the SMALL config of tests/test_torch_jax_params.py with the fused
encoder stacks and decoder layers on (the JAX kernels in interpret mode,
the port's plain versions on the CPU), in float32:

  * loss and every parameter gradient vs jax.value_and_grad (2e-5 on the
    loss, 1e-4 on the gradients: float32 summation order through the
    fused backward);
  * the learning rate at every step vs optax.cosine_onecycle_schedule
    (1e-6 relative and 1e-6 of the peak absolute: optax evaluates it in
    float32, which cancels digits near the end of the decay);
  * clipping vs optax.clip_by_global_norm (1e-6);
  * three AdamW steps with clipping and EMA from numpy-made t / noise vs
    the same loop with the JAX package's make_optimizer (optax): params
    and EMA within 1e-5 after each step (each update moves a parameter by
    at most ~lr = 1e-3 here; float32 gradient differences change that by
    far less), the key biases within 2 lr per step (their gradient is zero
    in exact arithmetic, so AdamW's normalised step of float32 noise has
    either sign).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccerdiffusion_tpu.diffusion import add_noise as jax_add_noise
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import add_noise, make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.trainer import (
    clip_by_global_norm,
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils import load_jax_params

from tests.test_torch_jax_params import SMALL, build_pair, to_jax, to_torch

FUSED = dataclasses.replace(SMALL, encoder_fused_stack=True, decoder_fused_block=True)
B, STEPS = 4, 3


def step_inputs(cfg, rng):
    t = rng.integers(0, 100, (B,)).astype(np.int32)
    noise = rng.standard_normal((B, cfg.trajectory_prediction_length, cfg.num_joints)).astype(np.float32)
    target = rng.uniform(0, 2 * np.pi, noise.shape).astype(np.float32)
    return t, noise, target


def jax_loss_fn(jmodel, schedule, batch, target, noise, t):
    noisy = jax_add_noise(schedule, jnp.asarray(target), jnp.asarray(noise), jnp.asarray(t))

    def loss(params):
        pred = jmodel.apply({"params": params}, batch, noisy, jnp.asarray(t), True)
        return jnp.mean(jnp.square(pred.astype(jnp.float32) - jnp.asarray(noise)))

    return loss


def grads_as_model(model, grads):
    """The JAX gradient tree laid out as the port's parameters."""
    return dict(load_jax_params(copy.deepcopy(model), jax.tree.map(np.asarray, grads)).named_parameters())


def test_loss_and_grads_match_jax():
    jmodel, variables, model, batch, rng = build_pair(FUSED, b=B)
    t, noise, target = step_inputs(FUSED, rng)
    loss_fn = jax_loss_fn(jmodel, jax_make_schedule(100), to_jax(batch), target, noise, t)
    want_loss, want = jax.value_and_grad(loss_fn)(variables["params"])
    noisy = add_noise(make_schedule(100), torch.from_numpy(target), torch.from_numpy(noise),
                      torch.from_numpy(t))
    pred = model(to_torch(batch), noisy, torch.from_numpy(t))
    loss = torch.mean((pred - torch.from_numpy(noise)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-5, rtol=0)
    ref = grads_as_model(model, want)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].detach().numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("total", [4, 5, 10, 37, 1000])
def test_lr_matches_optax_onecycle(total):
    sched = optax.cosine_onecycle_schedule(transition_steps=total, peak_value=3e-4, pct_start=0.3,
                                           div_factor=25.0, final_div_factor=1e4)
    for step in list(range(min(total + 3, 60))) + [total - 1, total, total + 50]:
        np.testing.assert_allclose(lr_at_step(3e-4, total, step), float(sched(step)), rtol=1e-6,
                                   atol=1e-6 * 3e-4, err_msg=f"step {step}")


def test_lr_is_finite_below_four_steps():
    """optax divides 0/0 in the empty warm-up interval there (NaN); the port
    skips the empty interval and decays from the peak."""
    for total in (1, 2, 3):
        lrs = [lr_at_step(1e-3, total, s) for s in range(total + 2)]
        assert np.isfinite(lrs).all() and lrs[0] == pytest.approx(1e-3)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])),
                               rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_three_step_trajectory_matches_optax_loop():
    jmodel, variables, model, batch, rng = build_pair(FUSED, b=B)
    lr, total, clip, decay = 1e-3, 10, 0.5, 0.9
    jschedule = jax_make_schedule(100)
    jopt = jax_make_optimizer(lr, total, weight_decay=1e-2, grad_clip_norm=clip)
    params = variables["params"]
    opt_state = jopt.init(params)
    ema = jax.tree.map(jnp.copy, params)

    opt = make_optimizer(model, lr, total, weight_decay=1e-2, grad_clip_norm=clip)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(FUSED.num_joints),
                           ema_decay=decay)
    for i in range(STEPS):
        t, noise, target = step_inputs(FUSED, rng)
        jbatch = {**to_jax(batch), "joint_command": jnp.asarray(target)}
        grads = jax.grad(jax_loss_fn(jmodel, jschedule, jbatch, target, noise, t))(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        d = min(decay, (1.0 + (i + 1)) / (10.0 + (i + 1)))
        ema = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), ema, params)

        tbatch = {**to_torch(batch), "joint_command": torch.from_numpy(target)}
        metrics = step.apply(state, tbatch, torch.from_numpy(t), torch.from_numpy(noise))
        assert np.isfinite(metrics["loss"].item()) and state.step == i + 1
        want_p, want_e = grads_as_model(model, params), grads_as_model(model, ema)
        # a key bias's gradient is zero in exact arithmetic, float32 noise in
        # both packages; AdamW scales that noise to a full step of ~lr, of
        # either sign, so those parameters may differ by 2 lr per step so far
        noise_bound = 2 * sum(lr_at_step(lr, total, k) for k in range(i + 1))
        for name, p in model.named_parameters():
            tol = noise_bound if name.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(p.detach().numpy(), want_p[name].detach().numpy(), atol=tol,
                                       rtol=0, err_msg=f"step {i}: {name}")
            np.testing.assert_allclose(state.ema[name].numpy(), want_e[name].detach().numpy(),
                                       atol=tol, rtol=0, err_msg=f"step {i}: ema {name}")


def test_metrics_and_generator_form():
    _, _, model, batch, _ = build_pair(FUSED, b=B)
    opt = make_optimizer(model, 1e-3, 10)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(FUSED.num_joints))
    rng = np.random.default_rng(3)
    tbatch = {**to_torch(batch), "joint_command": torch.from_numpy(step_inputs(FUSED, rng)[2])}
    metrics = step(state, tbatch, torch.Generator().manual_seed(0))
    assert set(metrics["grad_norms_by_layer"]) == {
        "step_encoding", "action_history_encoder", "imu_encoder", "joint_states_encoder",
        "game_state_encoder", "diffusion_action_generator"}
    assert np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0


def test_decoder_pretraining_updates_unused_params_like_optax():
    """Encoders get no gradient from random context tokens; as under
    jax.grad they see zero gradients, so AdamW's weight decay still moves them."""
    _, _, model, batch, rng = build_pair(FUSED, b=B)
    before = model.imu_encoder.seq.embedding.proj.weight.detach().clone()
    opt = make_optimizer(model, 1e-3, 10)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(FUSED.num_joints),
                           decoder_pretraining=True)
    tbatch = {**to_torch(batch), "joint_command": torch.from_numpy(step_inputs(FUSED, rng)[2])}
    metrics = step(create_train_state(model, opt), tbatch, torch.Generator().manual_seed(1))
    assert metrics["grad_norms_by_layer"]["imu_encoder"].item() == 0.0
    after = model.imu_encoder.seq.embedding.proj.weight.detach()
    torch.testing.assert_close(after, before * (1 - lr_at_step(1e-3, 10, 0) * 1e-2))


def test_unported_options_raise():
    """Every training option is ported now: flat_optimizer builds the flat
    optimizer (tests/test_torch_flat_optim.py), modality dropout and the aux
    cue loss build their steps (tests/test_torch_distill.py,
    tests/test_torch_train_options.py)."""
    _, _, model, _, _ = build_pair(SMALL, b=2)
    flat = make_optimizer(model, 1e-3, 10, flat=True)
    assert flat.flat and flat.in_buffer()
    make_train_step(model, make_schedule(100), flat, Normalizer.identity(6))
    opt = make_optimizer(model, 1e-3, 10)
    make_train_step(model, make_schedule(100), opt, Normalizer.identity(6), aux_cue_weight=0.5)
    make_train_step(model, make_schedule(100), opt, Normalizer.identity(6), modality_dropout=0.1)
