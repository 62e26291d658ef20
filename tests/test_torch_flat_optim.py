"""The flat optimizer (training/flat_optim.py, ``flat_optimizer: true``) and
the two resumes it brings (training/checkpoint.py), float32 on the CPU:

  * flat against per-tensor on the port, 3 steps of the train step: the
    parameters bit for bit without clipping (AdamW is elementwise); with it
    the flat norm sums in another order, and a last-bit change of the clip
    scale rounds updates the other way: within 2 ulps after a step, the
    larger of 2 ulps and 1e-7 after 3 (1.6e-6 of the update norm in all:
    more than the 1e-6 aimed at, every entry a few ulps), the entries whose
    gradient is float32 noise within 2 lr a step;
    every parameter's storage stays its slice of the buffer, and a
    ``module_lr_mults`` group is its own segment;
  * the port's flat step against the JAX package's ``flat_optimizer``
    trainer (``flat_wrap``) over 3 AdamW steps with clipping and EMA, at
    tests/test_torch_training.py's tolerances (1e-5 on the parameters, the
    key biases within 2 lr a step);
  * the serving weight cache (``models/transformer.py:packed_weights``)
    follows a flat update: the chunks served after flat training equal
    those after per-tensor training;
  * the port's own flat ``state.pt`` resumes bit for bit into a flat run
    and is refused, naming the knob, by a per-tensor one;
  * a JAX-written ``flat_optimizer`` checkpoint resumed by the port, flat
    and per-tensor, against the JAX trainer continuing 2 steps;
  * a JAX-written distillation checkpoint (``optax.masked`` moments over
    ``TRAINABLE``) resumed by the port's distill step against the JAX
    distiller continuing 2 steps.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccerdiffusion_tpu.config import Config as JaxConfig
from soccerdiffusion_tpu.config import TrainConfig as JaxTrainConfig
from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import add_noise as jax_add_noise
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.training import checkpoint as jax_checkpoint
from soccerdiffusion_tpu.training.distill import make_distill_step as jax_make_distill_step
from soccerdiffusion_tpu.training.trainer import TrainState as JaxTrainState
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu.training.trainer import make_train_step as jax_make_train_step
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference.sampler import make_chunk_sampler
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint, unravel
from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, make_distill_step
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from tests.test_torch_distill import assert_params, with_target
from tests.test_torch_jax_params import SMALL, build_pair, port_config, to_jax, to_torch
from tests.test_torch_training import grads_as_model, step_inputs

B, STEPS, LR, TOTAL, CLIP, DECAY, SEED = 4, 3, 1e-3, 10, 0.5, 0.9, 5
FUSED = dataclasses.replace(SMALL, encoder_fused_stack=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's small steps: the test run shares
    the cores among its worker processes, and several threads a worker
    contend for them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def base():
    """build_pair(SMALL) once for the module (flax's init takes seconds):
    each test takes copies of its port model and rng."""
    return build_pair(SMALL, b=B)


def fresh(base):
    """(jax model, variables, a copy of the port model, batch, a copy of the rng)."""
    jmodel, variables, model, batch, rng = base
    return jmodel, variables, copy.deepcopy(model), batch, copy.deepcopy(rng)


def port_pair(pair_base, flat_kw=None, **kw):
    """Two port models from the same JAX init (``pair_base``: a build_pair
    result), one per-tensor and one flat optimizer (``kw`` for both,
    ``flat_kw`` for the flat one), with their train steps: [(model,
    optimizer, state, step)] * 2."""
    _, _, model, batch, rng = fresh(pair_base)
    cfg = model.config
    out = []
    for flat in (False, True):
        m = copy.deepcopy(model)
        opt = make_optimizer(m, LR, TOTAL, weight_decay=1e-2, flat=flat,
                             **{**kw, **((flat_kw or {}) if flat else {})})
        state = create_train_state(m, opt, ema=True)
        step = make_train_step(m, make_schedule(100), opt, Normalizer.identity(cfg.num_joints),
                               ema_decay=DECAY)
        out.append((m, opt, state, step))
    return out, batch, rng


def run_steps(pair, batch, rng, n=STEPS):
    for _ in range(n):
        t, noise, target = step_inputs(SMALL, rng)
        tbatch = {**to_torch(batch), "joint_command": torch.from_numpy(target)}
        for _, _, state, step in pair:
            step.apply(state, tbatch, torch.from_numpy(t), torch.from_numpy(noise))


def assert_in_buffer(opt):
    assert opt.in_buffer()
    base, end = opt.buffer.data_ptr(), opt.buffer.data_ptr() + 4 * opt.buffer.numel()
    assert all(base <= p.data_ptr() < end for p in opt.params)
    assert {p.untyped_storage().data_ptr() for p in opt.params} == {
        opt.buffer.untyped_storage().data_ptr()}


def test_flat_equals_per_tensor_bit_for_bit_without_clipping(base):
    pair, batch, rng = port_pair(base)
    run_steps(pair, batch, rng)
    (a, _, sa, _), (b, opt, sb, _) = pair
    assert_in_buffer(opt)
    assert sa.step == sb.step == STEPS
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(sa.ema[name], sb.ema[name]), name
    assert len(opt.segments) == 1 and opt.buffer.numel() == sum(p.numel() for p in a.parameters())


def test_flat_clips_by_the_flat_norm(base):
    """The flat norm sums in another order than the per-tensor one, so the
    clip scale may differ in its last bit and an update round the other way:
    after the first step (the same gradients) each parameter within 2 float32
    ulps of the larger of its value and the learning rate; after 3 (the
    gradients now of parameters that differ in their last bits) within the
    larger of that and 1e-7, a ten-thousandth of a step; except the entries
    whose gradient has been at float32 noise level (|g| < 1e-6, among them
    every key bias, zero in exact arithmetic), which AdamW turns into ~lr
    steps of either sign: within 2 lr a step (tests/test_torch_training.py)."""
    pair, batch, rng = port_pair(base, grad_clip_norm=CLIP)
    noisy = {}
    for i in range(STEPS):
        run_steps(pair, batch, rng, n=1)
        bound = 2 * sum(lr_at_step(LR, TOTAL, k) for k in range(i + 1))
        for (n, p), q in zip(pair[0][0].named_parameters(), pair[1][0].parameters()):
            noisy[n] = noisy.get(n, False) | (p.grad.abs().numpy() < 1e-6)
            p, q = p.detach().numpy(), q.detach().numpy()
            close = 2 * np.spacing(np.maximum(np.abs(p), LR))
            if i > 0:
                close = np.maximum(close, 1e-7)
            tol = np.where(noisy[n], bound, close)
            assert (np.abs(p - q) <= tol).all(), (i, n, np.abs(p - q).max())
    assert_in_buffer(pair[1][1])
    assert not all(torch.equal(p, q) for p, q in zip(pair[0][0].parameters(),
                                                      pair[1][0].parameters()))


def test_lr_groups_are_segments_and_a_step_keeps_the_views(base):
    pair, batch, rng = port_pair(base, module_lr_mults={"diffusion_action_generator": 3.0})
    run_steps(pair, batch, rng, n=2)
    (a, pa, _, _), (b, opt, _, _) = pair
    assert len(opt.segments) == 2 and [g["lr_mult"] for g in opt.adamw.param_groups] == [1.0, 3.0]
    assert opt.state_names == pa.state_names
    assert_in_buffer(opt)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    # the state by parameter, as the per-tensor optimizer's
    got, want = opt.state_dict(), pa.state_dict()
    assert [len(g["params"]) for g in got["param_groups"]] == [
        len(g["params"]) for g in want["param_groups"]]
    for i, m in want["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][k], m[k]), (opt.state_names[i], k)


def test_flat_optimizer_refuses_missing_gradients():
    model = DiffusionPolicy(port_config(SMALL))
    opt = make_optimizer(model, LR, TOTAL, flat=True)
    with pytest.raises(ValueError, match="needs a gradient"):
        opt.step(0)


def test_served_chunks_follow_a_flat_update():
    """The fused encoder stacks pack their bf16 weights once per parameter
    version; the flat step's in-place update of the buffer must move the
    views' version, so the chunk served after it is the per-tensor one's."""
    pair, batch, rng = port_pair(build_pair(FUSED, b=B))
    noise = torch.from_numpy(rng.standard_normal(
        (B, FUSED.trajectory_prediction_length, FUSED.num_joints)).astype(np.float32))
    serve = lambda m: make_chunk_sampler(m, make_schedule(100), Normalizer.identity(6), 3)(
        to_torch(batch), noise.clone())
    with torch.no_grad():
        before = [serve(m) for m, *_ in pair]
    stacks = [[mod for mod in m.modules() if hasattr(mod, "_packed")] for m, *_ in pair]
    assert stacks[1], "no fused weight cache was filled"
    keys = [mod._packed[0] for mod in stacks[1]]
    run_steps(pair, batch, rng, n=1)
    with torch.no_grad():
        after = [serve(m) for m, *_ in pair]
    assert [mod._packed[0] for mod in stacks[1]] != keys
    assert torch.equal(before[0], before[1]) and torch.equal(after[0], after[1])
    assert not torch.equal(before[1], after[1])


def jitted_grad(jmodel, schedule):
    """jax.grad of the train step's loss, jitted once (the inputs are
    arguments, so three steps compile one program)."""
    @jax.jit
    def grad(params, batch, target, noise, t):
        noisy = jax_add_noise(schedule, target, noise, t)

        def loss(p):
            pred = jmodel.apply({"params": p}, batch, noisy, t, True)
            return jnp.mean(jnp.square(pred.astype(jnp.float32) - noise))

        return jax.grad(loss)(params)

    return grad


def test_flat_steps_match_the_jax_flat_trainer(base):
    jmodel, variables, model, batch, rng = fresh(base)
    grad_fn = jitted_grad(jmodel, jax_make_schedule(100))
    jopt = jax_make_optimizer(LR, TOTAL, weight_decay=1e-2, grad_clip_norm=CLIP, flat=True)
    params = variables["params"]
    opt_state = jopt.init(params)
    assert jax.tree.leaves(opt_state)[1].ndim == 1  # one flat mu
    ema = jax.tree.map(jnp.copy, params)
    opt = make_optimizer(model, LR, TOTAL, weight_decay=1e-2, grad_clip_norm=CLIP, flat=True)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(SMALL.num_joints),
                           ema_decay=DECAY)
    for i in range(STEPS):
        t, noise, target = step_inputs(SMALL, rng)
        jbatch = {**to_jax(batch), "joint_command": jnp.asarray(target)}
        grads = grad_fn(params, jbatch, jnp.asarray(target), jnp.asarray(noise), jnp.asarray(t))
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        d = min(DECAY, (1.0 + (i + 1)) / (10.0 + (i + 1)))
        ema = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), ema, params)
        step.apply(state, {**to_torch(batch), "joint_command": torch.from_numpy(target)},
                   torch.from_numpy(t), torch.from_numpy(noise))
        if i == 0:
            want = grads_as_model(model, grads)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(), atol=1e-4,
                                           rtol=0, err_msg=name)
        want_p, want_e = grads_as_model(model, params), grads_as_model(model, ema)
        bound = 2 * sum(lr_at_step(LR, TOTAL, k) for k in range(i + 1))
        for name, p in model.named_parameters():
            tol = bound if name.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(p.detach().numpy(), want_p[name].detach().numpy(), atol=tol,
                                       rtol=0, err_msg=f"step {i}: {name}")
            np.testing.assert_allclose(state.ema[name].numpy(), want_e[name].detach().numpy(),
                                       atol=tol, rtol=0, err_msg=f"step {i}: ema {name}")
    assert_in_buffer(opt)


# ------------------------------------------------------------------ resumes

def hyperparams(cfg, **changes) -> dict:
    train = JaxTrainConfig(lr=LR, train_denoising_timesteps=100, ema_decay=DECAY,
                           grad_clip_norm=CLIP)
    return {**JaxConfig(model=cfg, train=train).to_dict(), **changes}


def test_port_flat_checkpoint_resumes_bit_for_bit_and_refuses_per_tensor(base, tmp_path):
    pair, batch, rng = port_pair(base)
    run_steps(pair, batch, rng, n=2)
    (_, _, sa, _), (b, opt, sb, _) = pair
    save_checkpoint(tmp_path / "flat", sb, Normalizer.identity(6),
                    hyperparams(SMALL, flat_optimizer=True), 0)
    inputs = [step_inputs(SMALL, rng)]
    model = DiffusionPolicy(port_config(SMALL))
    ropt = make_optimizer(model, LR, TOTAL, weight_decay=1e-2, flat=True)
    rstate = create_train_state(model, ropt, ema=True)
    ckpt = load_checkpoint(tmp_path / "flat", rstate)
    assert ckpt["flat_optimizer"] and rstate.step == 2
    assert_in_buffer(ropt)
    rstep = make_train_step(model, make_schedule(100), ropt, Normalizer.identity(6), ema_decay=DECAY)
    for t, noise, target in inputs:
        tbatch = {**to_torch(batch), "joint_command": torch.from_numpy(target)}
        pair[1][3].apply(sb, tbatch, torch.from_numpy(t), torch.from_numpy(noise))
        rstep.apply(rstate, tbatch, torch.from_numpy(t), torch.from_numpy(noise))
    assert_in_buffer(ropt)
    for (name, p), q in zip(b.named_parameters(), model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(sb.ema[name], rstate.ema[name]), name

    per_tensor = DiffusionPolicy(port_config(SMALL))
    state = create_train_state(per_tensor, make_optimizer(per_tensor, LR, TOTAL))
    with pytest.raises(ValueError, match="flat_optimizer: True.*flat_optimizer: False"):
        load_checkpoint(tmp_path / "flat", state)
    save_checkpoint(tmp_path / "tensor", sa, Normalizer.identity(6), hyperparams(SMALL), 0)
    with pytest.raises(ValueError, match="flat_optimizer: False.*flat_optimizer: True"):
        load_checkpoint(tmp_path / "tensor", create_train_state(
            model, make_optimizer(model, LR, TOTAL, flat=True)))


def test_unravel_follows_ravel_pytree():
    from jax.flatten_util import ravel_pytree

    rng = np.random.default_rng(0)
    tree = {"b": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                  "bias": rng.normal(size=(2,)).astype(np.float32)},
            "a": {"z": {"w": rng.normal(size=(2, 2, 3)).astype(np.float32)}}}
    flat, _ = ravel_pytree(tree)
    got = unravel(np.asarray(flat), tree)
    assert jax.tree.all(jax.tree.map(np.array_equal, got, tree))
    with pytest.raises(ValueError, match="does not ravel"):
        unravel(np.zeros(3, np.float32), tree)


class JaxFlatRun:
    """The JAX trainer with ``flat_optimizer`` (clipping, EMA) on SMALL."""

    def __init__(self, pair_base):
        self.jmodel, variables, _, self.batch, _ = pair_base
        self.params = variables["params"]
        self.optimizer = jax_make_optimizer(LR, TOTAL, grad_clip_norm=CLIP, flat=True)
        self.norm = JaxNormalizer(mean=jnp.linspace(2.5, 3.5, SMALL.num_joints),
                                  std=jnp.linspace(0.5, 1.5, SMALL.num_joints))
        self.step_fn = jax_make_train_step(self.jmodel, jax_make_schedule(100), self.optimizer,
                                           self.norm, donate=False, ema_decay=DECAY)

    def fresh_state(self):
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=self.params, batch_stats={},
                             opt_state=self.optimizer.init(self.params),
                             ema_params=jax.tree.map(jnp.copy, self.params))

    def target_batch(self, i):
        return with_target(SMALL, self.batch, np.random.default_rng(10 + i))

    def steps(self, state, first, n):
        losses = []
        for i in range(first, first + n):
            state, metrics = self.step_fn(state, to_jax(self.target_batch(i)), SEED)
            losses.append(float(metrics["loss"]))
        return state, losses

    def draws(self, step):
        t_key, noise_key, _ = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step), 3)
        shape = (B, SMALL.trajectory_prediction_length, SMALL.num_joints)
        return (np.asarray(jax.random.randint(t_key, (B,), 0, 100)),
                np.asarray(jax.random.normal(noise_key, shape, dtype=jnp.float32)))


@pytest.fixture(scope="module")
def jax_flat(base, tmp_path_factory):
    run = JaxFlatRun(base)
    state, _ = run.steps(run.fresh_state(), 0, 2)
    path = tmp_path_factory.mktemp("jax_flat") / "ckpt"
    jax_checkpoint.save_checkpoint(path, state, run.norm, hyperparams(SMALL, flat_optimizer=True), 0)
    restored = jax_checkpoint.load_checkpoint(path, run.fresh_state())["state"]
    jstate, jlosses = run.steps(restored, 2, 2)
    return run, path, jstate, jlosses


@pytest.mark.parametrize("flat", [True, False])
def test_jax_flat_checkpoint_resumes_like_the_jax_trainer(jax_flat, flat):
    run, path, jstate, jlosses = jax_flat
    model = DiffusionPolicy(port_config(SMALL))
    opt = make_optimizer(model, LR, TOTAL, grad_clip_norm=CLIP, flat=flat)
    state = create_train_state(model, opt, ema=True)
    ckpt = load_checkpoint(path, state)
    assert state.step == 2 and ckpt["format"] == "soccerdiffusion_tpu/msgpack"
    assert all(float(m["step"]) == 2.0 for m in opt.state_dict()["state"].values())
    if flat:
        assert_in_buffer(opt)
    step = make_train_step(model, make_schedule(100), opt, ckpt["norm"], ema_decay=DECAY)
    losses = []
    for i in (2, 3):
        t, noise = run.draws(i)
        metrics = step.apply(state, to_torch(run.target_batch(i)), torch.from_numpy(t),
                             torch.from_numpy(noise))
        losses.append(metrics["loss"].item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    bound = 2 * sum(lr_at_step(LR, TOTAL, k) for k in range(4))
    want_p = grads_as_model(model, jstate.params)
    want_e = grads_as_model(model, jstate.ema_params)
    for name, p in model.named_parameters():
        tol = bound if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].detach().numpy(), atol=tol,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want_e[name].detach().numpy(),
                                   atol=tol, rtol=0, err_msg=f"ema {name}")
    if flat:
        assert_in_buffer(opt)


def test_jax_distillation_checkpoint_resumes_like_the_jax_distiller(base, tmp_path):
    jmodel, variables, teacher, batch, rng = fresh(base)
    batch = with_target(SMALL, batch, rng)
    teacher_params = variables["params"]
    mask = lambda params: {k: k in TRAINABLE for k in params}
    jopt = optax.masked(jax_make_optimizer(LR, TOTAL, 1e-2), mask)
    jstep = jax_make_distill_step(jmodel, jax_make_schedule(100), jopt, teacher_inference_steps=4,
                                  donate=False, student_steps=2)
    jax_start = lambda: JaxTrainState(step=jnp.zeros((), jnp.int32),
                                  params=jax.tree.map(jnp.copy, teacher_params), batch_stats={},
                                  opt_state=jopt.init(teacher_params), ema_params={})
    jstate = jax_start()
    for _ in range(2):
        jstate, _ = jstep(jstate, teacher_params, to_jax(batch), SEED)
    norm = JaxNormalizer(mean=jnp.zeros(SMALL.num_joints), std=jnp.ones(SMALL.num_joints))
    jax_checkpoint.save_checkpoint(tmp_path / "student", jstate, norm,
                                   hyperparams(SMALL, distilled_num_steps=2), 0)
    jstate = jax_checkpoint.load_checkpoint(tmp_path / "student", jax_start())["state"]
    assert int(jstate.step) == 2

    teacher.requires_grad_(False)
    student = DiffusionPolicy(port_config(SMALL))
    opt = make_optimizer(student, LR, TOTAL, 1e-2, trainable=TRAINABLE)
    state = create_train_state(student, opt)
    load_checkpoint(tmp_path / "student", state)
    assert state.step == 2
    moments = opt.state_dict()["state"]
    assert len(moments) == len(opt.state_names) and all(
        float(m["step"]) == 2.0 for m in moments.values())
    step = make_distill_step(student, make_schedule(100), opt, teacher_inference_steps=4,
                             student_steps=2)
    shape = (B, SMALL.trajectory_prediction_length, SMALL.num_joints)
    noisy = {}
    for i in (2, 3):
        noise = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(SEED), i), shape,
                                             jnp.float32))
        jstate, jm = jstep(jstate, teacher_params, to_jax(batch), SEED)
        metrics = step.apply(state, teacher, to_torch(batch), torch.from_numpy(noise))
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-4)
        assert_params(student, jstate.params, i, noisy, "resumed distillation")
    frozen = dict(teacher.named_parameters())
    for name, p in student.named_parameters():
        if not name.startswith(TRAINABLE):
            assert torch.equal(p, frozen[name]), name


def test_chip_smoke_writes_the_jax_flat_and_masked_bytes(tmp_path):
    """chip_smoke.py's JAX-format writer (the card's machine has no JAX) for
    its flat and distillation resumes writes the bytes the JAX package's
    save_checkpoint writes for the same trees: a flat_optimizer state (one
    flat mu / nu, ravel_pytree's order) and an optax.masked one over
    TRAINABLE (the frozen modules' moments empty maps)."""
    from types import SimpleNamespace

    import chip_smoke
    from jax.flatten_util import ravel_pytree

    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params

    skeleton = DiffusionPolicy(port_config(SMALL))
    params = flax_init_params(skeleton, seed=0)[0]
    mu, nu = chip_smoke.ckpt_moments(skeleton, 3)
    norm = JaxNormalizer(mean=jnp.linspace(2.5, 3.5, 6), std=jnp.linspace(0.5, 1.5, 6))
    hp, count = hyperparams(SMALL), 4
    flat = jax_make_optimizer(LR, TOTAL, flat=True).init(params)
    np.testing.assert_array_equal(chip_smoke.ravel_tree(mu), np.asarray(ravel_pytree(mu)[0]))
    flat = (flat[0]._replace(count=jnp.asarray(count, jnp.int32), mu=ravel_pytree(mu)[0],
                             nu=ravel_pytree(nu)[0]), flat[1],
            flat[2]._replace(count=jnp.asarray(count, jnp.int32)))
    masked = optax.masked(jax_make_optimizer(LR, TOTAL, 1e-2),
                          lambda p: {k: k in TRAINABLE for k in p}).init(params)
    adam = masked.inner_state[0]
    fill = lambda tree, want: {k: want[k] if k in TRAINABLE else v for k, v in tree.items()}
    masked = masked._replace(inner_state=(
        adam._replace(count=jnp.asarray(count, jnp.int32), mu=fill(adam.mu, mu),
                      nu=fill(adam.nu, nu)), masked.inner_state[1],
        masked.inner_state[2]._replace(count=jnp.asarray(count, jnp.int32))))
    mine = {"flat": chip_smoke.jax_opt_state(chip_smoke.ravel_tree(mu), chip_smoke.ravel_tree(nu),
                                             count),
            "masked": chip_smoke.jax_masked_opt_state(mu, nu, count, TRAINABLE)}
    for name, opt_state in (("flat", flat), ("masked", masked)):
        state = SimpleNamespace(step=jnp.asarray(count, jnp.int32), params=params, batch_stats={},
                                opt_state=opt_state)
        jax_checkpoint.save_checkpoint(tmp_path / f"jax_{name}", state, norm, hp, 0)
        chip_smoke.write_jax_checkpoint(tmp_path / name, hp, params,
                                        (np.asarray(norm.mean), np.asarray(norm.std)),
                                        opt_state=mine[name], step=count, epoch=0)
        for f in ("state.msgpack", "hyperparams.json"):
            assert (tmp_path / name / f).read_bytes() == (tmp_path / f"jax_{name}" / f).read_bytes()
