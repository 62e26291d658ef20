"""Distillation (training/distill.py), modality dropout in the train step and
the policy checkpoint loader against the JAX package, float32 on the CPU:

  * the train step at ``modality_dropout=0.3`` against the JAX
    ``make_train_step``, fed JAX's own t, noise and dropout masks
    (``fold_in(key(seed), step)``, its ``fold_in(., 7)`` split in five):
    the first step's gradients within 1e-4, the loss within 1e-4 relative
    and the parameters within 1e-5 after each of 3 AdamW steps;
  * ``make_distill_step`` at 1 and 3 student steps, guided
    (2.0@action_history on a camera-free config, 3.0@image on a small ViT),
    with 2 teacher draws, guided (3.0@image) with 2 teacher draws (rolled
    out as one batch of 2 x B rows) and with the fused decoder layers (the
    JAX kernel in interpret mode), fed JAX's noise (``fold_in(key(seed), step)``,
    ``fold_in(., 1)`` for the draws): loss and grad_norm within 1e-4
    relative and the parameters within 1e-5 after each of 3 steps, the
    encoders' parameters and buffers bit for bit the teacher's;
  * the CLI end to end: ``train()`` with modality dropout, then
    ``distill.main`` for a 1-step student and a guided 2-step student of 2
    teacher draws, each decoded by ``load_policy_checkpoint`` and served by
    ``RolloutEngine``; the CLI's refusals, and its ``--db`` and
    ``--device-data``.

An entry whose gradient is at float32 noise level at some step (|g| <
1e-6 against gradients of 1e-3 .. 1e-1; a key bias's gradient, zero in
exact arithmetic since the softmax is invariant to it, is such noise in both
packages everywhere) takes AdamW's normalised step of ~lr of either sign,
so those entries are held within 2 lr per step taken so far, as the key
biases are in tests/test_torch_training.py; every other entry within 1e-5.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.training.distill import make_distill_step as jax_make_distill_step
from soccerdiffusion_tpu.training.trainer import TrainState as JaxTrainState
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu.training.trainer import make_train_step as jax_make_train_step
from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.data import dummy as pdummy
from soccerdiffusion_tpu_torch.data import schema as pschema
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training import distill
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, load_policy_checkpoint
from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, make_distill_step
from soccerdiffusion_tpu_torch.training.train import RunOptions, train
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from tests.test_torch_guidance import VIT
from tests.test_torch_jax_params import SMALL, build_pair, to_jax, to_torch
from tests.test_torch_sqlite import write_db
from tests.test_torch_training import grads_as_model

B, STEPS, LR, TOTAL, SEED = 4, 3, 1e-3, 10, 5


def with_target(cfg, batch, rng):
    target = rng.uniform(0, 2 * np.pi, (B, cfg.trajectory_prediction_length, cfg.num_joints))
    return {**batch, "joint_command": target.astype(np.float32)}


def assert_params(model, want, step, noisy, what=""):
    """The port's parameters against a JAX tree after ``step``; ``noisy``
    (name -> bool array) gathers the entries whose gradient has been at noise
    level, which are held within AdamW's noise bound (module docstring)."""
    bound = 2 * sum(lr_at_step(LR, TOTAL, k) for k in range(step + 1))
    ref = grads_as_model(model, want)
    for name, p in model.named_parameters():
        if p.grad is not None:
            noisy[name] = noisy.get(name, False) | (p.grad.abs().numpy() < 1e-6)
        tol = np.where(noisy.get(name, False), bound, 1e-5)
        diff = np.abs(p.detach().numpy() - ref[name].detach().numpy())
        assert (diff <= tol).all(), (f"{what} step {step}: {name}: max |difference| "
                                     f"{(diff - tol).max() + tol.max()}")


def test_train_step_with_modality_dropout_matches_jax():
    jmodel, variables, model, batch, rng = build_pair(SMALL, b=B)
    batch = with_target(SMALL, batch, rng)
    p = 0.3
    jopt = jax_make_optimizer(LR, TOTAL, weight_decay=1e-2)
    jstep = jax_make_train_step(jmodel, jax_make_schedule(100), jopt,
                                JaxNormalizer.identity(SMALL.num_joints), donate=False,
                                modality_dropout=p)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=jopt.init(variables["params"]),
                           ema_params={})
    opt = make_optimizer(model, LR, TOTAL, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(SMALL.num_joints),
                           modality_dropout=p)
    dropped, noisy = 0, {}
    for i in range(STEPS):
        # the JAX step's draws: t and noise from split(rng, 3), the masks from fold_in(rng, 7)
        key = jax.random.fold_in(jax.random.key(SEED), i)
        t_key, noise_key, _ = jax.random.split(key, 3)
        t = np.asarray(jax.random.randint(t_key, (B,), 0, 100))
        noise = np.asarray(jax.random.normal(noise_key, batch["joint_command"].shape, jnp.float32))
        masks = np.stack([np.asarray(jax.random.bernoulli(k, p, (B,)))
                          for k in jax.random.split(jax.random.fold_in(key, 7), 5)])
        dropped += masks.sum()
        if i == 0:
            from soccerdiffusion_tpu.data.pipeline import dropout_modalities
            from soccerdiffusion_tpu.diffusion import add_noise

            jb = dropout_modalities(to_jax(batch), jax.random.fold_in(key, 7), p)
            x_t = add_noise(jax_make_schedule(100), jb["joint_command"], jnp.asarray(noise),
                            jnp.asarray(t))
            loss_fn = lambda prm: jnp.mean(jnp.square(
                jmodel.apply({"params": prm}, jb, x_t, jnp.asarray(t), True) - noise))
            want_grads = jax.grad(loss_fn)(jstate.params)
        jstate, jmetrics = jstep(jstate, to_jax(batch), SEED)
        metrics = step.apply(state, to_torch(batch), torch.from_numpy(t), torch.from_numpy(noise),
                             masks=torch.from_numpy(masks))
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                                   rtol=1e-4)
        if i == 0:
            ref = grads_as_model(model, want_grads)
            for name, prm in model.named_parameters():
                np.testing.assert_allclose(prm.grad.numpy(), ref[name].detach().numpy(),
                                           atol=1e-4, rtol=0, err_msg=name)
        assert_params(model, jstate.params, i, noisy, "dropout")
    assert dropped > 0


def test_train_step_draws_masks_after_t_and_noise():
    """At p > 0 the generator's t and noise are those of a p = 0 step: the
    masks are drawn after them."""
    _, _, model, batch, rng = build_pair(SMALL, b=B)
    batch = to_torch(with_target(SMALL, batch, rng))
    seen = {}
    for p in (0.0, 0.5):
        m = copy.deepcopy(model)
        step = make_train_step(m, make_schedule(100), make_optimizer(m, LR, TOTAL),
                               Normalizer.identity(6), modality_dropout=p)
        step.apply = lambda state, b, t, noise, ctx=None, masks=None, p=p: seen.__setitem__(
            p, (t, noise, masks))
        step(create_train_state(m, step.optimizer), batch, torch.Generator().manual_seed(3))
    assert torch.equal(seen[0.0][0], seen[0.5][0]) and torch.equal(seen[0.0][1], seen[0.5][1])
    assert seen[0.0][2] is None and seen[0.5][2].shape == (5, B)


def test_masked_optimizer_leaves_the_other_parameters():
    """AdamW over the denoiser and the step token only: no other parameter
    moves, weight decay included; the trainable ones move by ~lr."""
    _, _, model, _, _ = build_pair(SMALL, b=B)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, LR, TOTAL, weight_decay=0.5, trainable=TRAINABLE)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step(0)
    for name, p in model.named_parameters():
        moved = not torch.equal(p, before[name])
        assert moved == name.startswith(TRAINABLE), name
    with pytest.raises(ValueError, match="no parameter"):
        make_optimizer(model, LR, TOTAL, trainable=("nothing",))


FUSED = dataclasses.replace(SMALL, decoder_fused_block=True)
DISTILL = {
    "student1": (SMALL, dict(student_steps=1)),
    "student3": (SMALL, dict(student_steps=3)),
    "guided_history": (SMALL, dict(student_steps=1, guidance_scale=2.0,
                                   guidance_null=("action_history",))),
    "guided_image": (VIT, dict(student_steps=3, guidance_scale=3.0, guidance_null=("image",))),
    "draws2": (SMALL, dict(student_steps=1, teacher_draws=2)),
    "guided_draws": (VIT, dict(student_steps=1, guidance_scale=3.0, guidance_null=("image",),
                               teacher_draws=2)),
    "fused_decoder": (FUSED, dict(student_steps=3)),
}
TEACHER_STEPS = 4


@pytest.mark.parametrize("case", list(DISTILL))
def test_distill_step_matches_jax(case):
    cfg, kw = DISTILL[case]
    jmodel, variables, teacher, batch, rng = build_pair(cfg, b=B)
    batch = with_target(cfg, batch, rng)
    teacher_params = variables["params"]
    mask = lambda params: {k: k in TRAINABLE for k in params}
    jopt = optax.masked(jax_make_optimizer(LR, TOTAL, 1e-2), mask)
    jstep = jax_make_distill_step(jmodel, jax_make_schedule(100), jopt,
                                  teacher_inference_steps=TEACHER_STEPS, donate=False, **kw)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.copy, teacher_params), batch_stats={},
                           opt_state=jopt.init(teacher_params), ema_params={})
    teacher.requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True)
    opt = make_optimizer(student, LR, TOTAL, 1e-2, trainable=TRAINABLE)
    state = create_train_state(student, opt)
    step = make_distill_step(student, make_schedule(100), opt,
                             teacher_inference_steps=TEACHER_STEPS, **kw)
    shape = (B, cfg.trajectory_prediction_length, cfg.num_joints)
    draws, noisy = kw.get("teacher_draws", 1), {}
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.key(SEED), i)
        noise = np.asarray(jax.random.normal(key, shape, jnp.float32))
        draw_noise = None
        if draws > 1:
            draw_noise = torch.from_numpy(np.asarray(jax.random.normal(
                jax.random.fold_in(key, 1), (draws, *shape), jnp.float32)))
        jstate, jm = jstep(jstate, teacher_params, to_jax(batch), SEED)
        metrics = step.apply(state, teacher, to_torch(batch), torch.from_numpy(noise), draw_noise)
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert_params(student, jstate.params, i, noisy, case)
    frozen = dict(teacher.named_parameters())
    for name, p in student.named_parameters():
        if not name.startswith(TRAINABLE):
            assert torch.equal(p, frozen[name]), name
        else:
            assert not torch.equal(p, frozen[name]), name
    for (name, b), tb in zip(student.named_buffers(), teacher.buffers()):
        assert torch.equal(b, tb), name


def test_distill_step_refuses_like_jax():
    _, _, model, _, _ = build_pair(SMALL, b=2)
    opt = make_optimizer(model, LR, TOTAL, trainable=TRAINABLE)
    for kw, match in ((dict(student_steps=0), "student_steps"), (dict(teacher_draws=0),
                                                                  "teacher_draws")):
        with pytest.raises(ValueError, match=match):
            jax_make_distill_step(None, None, None, **kw)
        with pytest.raises(ValueError, match=match):
            make_distill_step(model, make_schedule(100), opt, **kw)


TINY = {
    "hidden_dim": 64, "num_decoder_layers": 2, "num_decoder_heads": 4,
    "action_context_length": 12, "imu_context_length": 12, "joint_state_context_length": 12,
    "trajectory_prediction_length": 5, "use_images": False, "use_gamestate": True,
    "num_action_history_encoder_layers": 1, "num_imu_encoder_layers": 1,
    "joint_state_encoder_layers": 1, "batch_size": 8, "lr": 1e-3, "ema_decay": 0.9,
    "modality_dropout": 0.15, "num_normalization_samples": 50, "log_every": 1,
    "train_denoising_timesteps": 100, "distill_teacher_inference_steps": 3,
}


def test_cli_trains_distills_and_serves(tmp_path):
    yml = tmp_path / "tiny.yaml"
    yml.write_text(yaml.safe_dump(TINY))
    config = Config.from_yaml(str(yml))
    teacher_ckpt = str(tmp_path / "teacher")
    state = train(config, RunOptions(output=teacher_ckpt, epochs=1, steps_per_epoch=2, seed=0,
                                     device="cpu"))
    assert state.step == 2 and state.ema
    common = ["--dummy-data", "--epochs", "1", "--steps-per-epoch", "2", "--device", "cpu"]
    one, two = str(tmp_path / "student1"), str(tmp_path / "student2")
    distill.main([str(yml), teacher_ckpt, "-o", one, "--student-steps", "1",
                  "--metrics", str(tmp_path / "m1.jsonl"), *common])
    distill.main([str(yml), teacher_ckpt, "-o", two, "--student-steps", "2", "--guidance",
                  "2.0@action_history", "--teacher-draws", "2", *common])
    records = [json.loads(line) for line in open(tmp_path / "m1.jsonl")]
    assert [r["step"] for r in records] == [0, 1] and all(np.isfinite(r["loss"]) for r in records)

    hp1, hp2 = (load_checkpoint(p)["hyperparams"] for p in (one, two))
    assert hp1["distilled_decoder"] is True and "distilled_num_steps" not in hp1
    assert "distilled_guidance_scale" not in hp1 and "distilled_teacher_draws" not in hp1
    assert hp2["distilled_num_steps"] == 2 and "distilled_decoder" not in hp2
    assert hp2["distilled_guidance_scale"] == 2.0
    assert hp2["distilled_guidance_null"] == ["action_history"]
    assert hp2["distilled_teacher_draws"] == 2

    # the teacher serves its EMA weights, the students their own parameters
    raw = load_checkpoint(teacher_ckpt)
    _, sd, _, steps, distilled = load_policy_checkpoint(teacher_ckpt)
    assert (steps, distilled) == (3, False)
    name = "diffusion_action_generator.fc_out.weight"
    assert torch.equal(sd[name], raw["ema"][name]) and not torch.equal(sd[name], raw["params"][name])
    assert torch.equal(load_policy_checkpoint(teacher_ckpt, prefer_ema=False)[1][name],
                       raw["params"][name])
    for path, want, ddim_steps in ((one, (1, True), None), (two, (2, False), 2)):
        hp, sd, norm, steps, distilled = load_policy_checkpoint(path)
        assert (steps, distilled) == want
        student = load_checkpoint(path)
        assert student["ema"] == {} and torch.equal(sd[name], student["params"][name])
        model = DiffusionPolicy(Config.from_dict(hp).model)
        model.load_state_dict(sd)
        # the encoders are the teacher's (EMA) weights, the denoiser moved
        enc = "imu_encoder.seq.embedding.proj.weight"
        assert torch.equal(sd[enc], raw["ema"][enc])
        assert not torch.equal(sd[name], raw["ema"][name])
        engine = RolloutEngine(model, make_schedule(100), norm, num_inference_steps=steps,
                               distilled=distilled, device="cpu")
        carry, chunk = engine.replan_period(engine.init(3, torch.Generator().manual_seed(0)))
        assert chunk.shape == (3, 5, 20) and torch.isfinite(chunk).all()


@pytest.mark.parametrize("flags,error,match", [
    (["--device", "cuda"], RuntimeError, "CUDA is not available"),
    (["--db", "DB", "--device", "cpu"], None, None),
    (["--dummy-data", "--device-data", "--device", "cpu"], None, None),
    (["--dummy-data", "--mesh", "data=2", "--device", "cpu"], ValueError,
     "needs 2 ranks, have 1"),
    (["--device", "cpu"], FileNotFoundError, "no SQLite dataset at .*default.sqlite3"),
], ids=["cuda", "db", "device_data", "mesh", "no_dummy_data"])
def test_cli_refusals(tmp_path, monkeypatch, flags, error, match):
    """What the CLI refuses (no card, a mesh over more ranks than the process
    group holds (one process here: the parallel/ slice distils over several), no database
    at DB_PATH without --dummy-data) and, since the recorded-data slice, the
    two it takes: a SQLite database (--db) and the dataset resident on the
    device (--device-data), each distilling a teacher 2 steps."""
    import soccerdiffusion_tpu_torch

    if flags[:2] == ["--device", "cuda"] and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(soccerdiffusion_tpu_torch, "DB_PATH", str(tmp_path / "default.sqlite3"))
    yml = tmp_path / "tiny.yaml"
    yml.write_text(yaml.safe_dump(TINY))
    flags = [str(write_db(tmp_path / "db.sqlite3", pschema, pdummy)) if f == "DB" else f
             for f in flags]
    teacher = tmp_path / "missing"
    if error is None:
        teacher = tmp_path / "teacher"
        train(Config.from_yaml(str(yml)), RunOptions(output=str(teacher), epochs=1,
                                                     steps_per_epoch=2, device="cpu"))
        state = distill.main([str(yml), str(teacher), "-o", str(tmp_path / "student"),
                              "--epochs", "1", "--steps-per-epoch", "2", *flags])
        assert state.step == 2
        assert load_checkpoint(tmp_path / "student")["hyperparams"]["distilled_decoder"] is True
        return
    extra = ["--dummy-data"] if flags[:2] == ["--device", "cuda"] else []
    with pytest.raises(error, match=match):
        distill.main([str(yml), str(teacher), *extra, *flags])


def test_cli_rejects_a_bad_guidance_spec(tmp_path):
    yml = tmp_path / "tiny.yaml"
    yml.write_text(yaml.safe_dump(TINY))
    with pytest.raises(SystemExit):
        distill.main([str(yml), str(tmp_path / "missing"), "--dummy-data", "--guidance",
                      "2.0@camera", "--device", "cpu"])
