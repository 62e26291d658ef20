"""The last training options against the JAX package, float32 on the CPU
(the train step with the aux cue head is tests/test_torch_cue_head.py):

  * ``image_encoder_lr_mult`` 3 on a tiny ResNet config: the port's
    optimizer against the JAX package's optax chain (AdamW, then the
    image encoder's update scaled by 3; with and without clipping first)
    on the same seeded gradients, the parameters within 1e-5 after each of
    3 steps;
  * ``ddpm_step`` against the JAX step with the same noise (1e-6), and
    ``ddpm_sample`` over a 50-step schedule with the JAX sampler's draws
    injected (1e-5);
  * ``--pretrained-decoder`` copies exactly the decoder and the step token,
    from the checkpoint's raw parameters and not its EMA;
  * ``train --db`` (windows, ``--packed``, ``--device-data``) and
    ``distill --db`` / ``--device-data`` run end to end on the CPU from a
    48 px database;
  * the aux loss is trained on the vision task's windows and switched off,
    with the JAX trainer's warning, on ``--packed`` (whose batches carry no
    labels).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from soccerdiffusion_tpu.diffusion import ddim as jddim
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data import dummy as pdummy
from soccerdiffusion_tpu_torch.data import schema as pschema
from soccerdiffusion_tpu_torch.diffusion import ddpm_sample, ddpm_step, make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training import distill, train
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint
from soccerdiffusion_tpu_torch.training.trainer import make_optimizer
from soccerdiffusion_tpu_torch.utils import load_jax_params
from soccerdiffusion_tpu_torch.utils.jax_params import random_jax_params
from tests.test_torch_distill import LR, TOTAL
from tests.test_torch_image_configs import CONFIGS
from tests.test_torch_jax_params import port_config
from tests.test_torch_sqlite import write_db

STEPS = 3

@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no_clip", "clip_0.5"])
def test_image_encoder_lr_mult_matches_optax(clip):
    """The same seeded gradients (unit scale) into the port's optimizer and
    the JAX package's optax chain, 3 steps. AdamW's first step moves every
    entry by ~lr whatever its gradient, so there the ResNet's entries move
    3x as far as the others: the multiplier took effect on both sides."""
    cfg = CONFIGS["default"]
    rng = np.random.default_rng(5)
    holder = DiffusionPolicy(port_config(cfg))
    params, stats = random_jax_params(holder, 2)  # the flax layout, as optax sees it
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
             for _ in range(STEPS)]

    def as_model(tree):  # a flax tree laid out as the port's parameters
        load_jax_params(holder, jax.tree.map(np.asarray, tree), stats)
        return {n: p.detach().clone() for n, p in holder.named_parameters()}

    model = load_jax_params(DiffusionPolicy(port_config(cfg)), params, stats)
    mults = {"image_sequence_encoder": 3.0}
    opt = make_optimizer(model, LR, TOTAL, 1e-2, module_lr_mults=mults, grad_clip_norm=clip)
    jopt = jax_make_optimizer(LR, TOTAL, 1e-2, module_lr_mults=mults, grad_clip_norm=clip)
    assert sorted(g["lr_mult"] for g in opt.adamw.param_groups) == [1.0, 3.0]
    jparams, jstate = params, jopt.init(params)
    for i, g in enumerate(grads):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        grad = as_model(g)
        for name, p in model.named_parameters():
            p.grad = grad[name]
        opt.step(i)
        updates, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want = as_model(jparams)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"step {i}: {name}")
        if i == 0:
            moved = {True: [], False: []}
            for name, p in model.named_parameters():
                moved[name.startswith("image_sequence_encoder.")].append(
                    (p.detach() - before[name]).abs().flatten())
            ratio = torch.cat(moved[True]).mean() / torch.cat(moved[False]).mean()
            assert 2.9 < ratio < 3.1, ratio


@pytest.mark.parametrize("t", [999, 500, 1, 0])
def test_ddpm_step_matches_jax(t):
    rng = np.random.default_rng(t)
    x, eps, noise = (rng.standard_normal((3, 5, 6)).astype(np.float32) for _ in range(3))
    want = jddim.ddpm_step(jax_make_schedule(1000), jnp.asarray(eps), jnp.asarray(t),
                           jnp.asarray(x), jnp.asarray(noise))
    got = ddpm_step(make_schedule(1000), torch.from_numpy(eps), t, torch.from_numpy(x),
                    torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    if t == 0:  # no noise at the last step
        zero = ddpm_step(make_schedule(1000), torch.from_numpy(eps), t, torch.from_numpy(x),
                         torch.zeros(3, 5, 6))
        torch.testing.assert_close(got, zero, atol=0, rtol=0)


@pytest.mark.parametrize("source", ["jax_noise", "generator"])
def test_ddpm_sample_matches_jax(source):
    """50 ancestral steps of the oracle denoiser of a fixed x0 (the epsilon
    that x_t holds about it) in both packages: with the JAX sampler's own
    draws injected, the samples within 1e-5; from a torch generator, a seed
    gives one sample and another seed another."""
    T, shape = 50, (2, 5, 6)
    rng = np.random.default_rng(1)
    x_t, x0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    schedule = make_schedule(T)
    abar = schedule.alphas_cumprod

    def torch_eps(x, t):
        a = torch.tensor(abar[t])
        return (x - torch.sqrt(a) * torch.from_numpy(x0)) / torch.sqrt(1.0 - a)

    if source == "jax_noise":
        key, draws = jax.random.key(3), []
        for _ in range(T):  # ddpm_sample's split per step
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))

        def jax_eps(x, t):
            a = jnp.take(jnp.asarray(abar), t)
            return (x - jnp.sqrt(a) * x0) / jnp.sqrt(1.0 - a)

        want = jddim.ddpm_sample(jax_make_schedule(T), jax_eps, jnp.asarray(x_t), jax.random.key(3))
        got = ddpm_sample(schedule, torch_eps, torch.from_numpy(x_t),
                          noise=torch.from_numpy(np.stack(draws)))
        assert np.abs(np.asarray(want) - x0).max() < 0.5  # the sampler returned to x0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        with pytest.raises(ValueError, match="noise"):
            ddpm_sample(schedule, lambda x, t: x, torch.from_numpy(x_t), noise=torch.zeros(3))
    else:
        run = lambda seed: ddpm_sample(schedule, torch_eps, torch.from_numpy(x_t),
                                       torch.Generator().manual_seed(seed))
        a, b, c = run(0), run(0), run(1)
        assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()


TINY = {
    "hidden_dim": 64, "num_decoder_layers": 2, "num_decoder_heads": 4, "num_joints": 20,
    "action_context_length": 12, "imu_context_length": 12, "joint_state_context_length": 12,
    "trajectory_prediction_length": 5, "use_images": True, "image_encoder_type": "vit",
    "image_resolution": 32, "vit_patch_size": 8, "vit_width": 64, "vit_depth": 1,
    "image_context_length": 2, "num_action_history_encoder_layers": 1,
    "num_imu_encoder_layers": 1, "joint_state_encoder_layers": 1, "batch_size": 8, "lr": 1e-3,
    "ema_decay": 0.9, "num_normalization_samples": 50, "log_every": 1,
    "train_denoising_timesteps": 100, "distill_teacher_inference_steps": 3,
    "image_encoder_lr_mult": 3.0,
}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A 48 px database, the tiny YAML and a checkpoint trained from it."""
    root = tmp_path_factory.mktemp("recorded")
    db = write_db(root / "db.sqlite3", pschema, pdummy)
    yml = root / "tiny.yaml"
    yml.write_text(yaml.safe_dump(TINY))
    train.main(["-c", str(yml), "--db", str(db), "--epochs", "1", "--steps-per-epoch", "2",
                "-o", str(root / "teacher"), "--device", "cpu"])
    return root, db, yml


def test_pretrained_decoder_copies_the_raw_decoder(recorded):
    root, _, yml = recorded
    ckpt = load_checkpoint(root / "teacher")
    assert ckpt["ema"], "the teacher keeps an EMA: the copy must not take it"
    model = DiffusionPolicy(Config.from_yaml(str(yml)).model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    copied = train.load_pretrained_decoder(model, str(root / "teacher"))
    decoder = {n for n in before if n.startswith(("diffusion_action_generator.", "step_encoding."))}
    assert set(copied) == decoder and len(decoder) > 10
    for name, p in model.named_parameters():
        if name in decoder:
            assert torch.equal(p, ckpt["params"][name]), name
            assert not torch.equal(p, ckpt["ema"][name]), name
        else:
            assert torch.equal(p, before[name]), name


@pytest.mark.parametrize("flags", [[], ["--packed"], ["--device-data"],
                                   ["--pretrained-decoder", "teacher"]],
                         ids=["windows", "packed", "device_data", "pretrained_decoder"])
def test_train_from_a_database(recorded, flags, tmp_path, caplog):
    root, db, yml = recorded
    flags = [str(root / f) if f == "teacher" else f for f in flags]
    metrics = tmp_path / "m.jsonl"
    with caplog.at_level(logging.INFO, logger="soccerdiffusion_tpu_torch"):
        state = train.main(["-c", str(yml), "--db", str(db), "--epochs", "1",
                            "--steps-per-epoch", "2", "-o", str(tmp_path / "out"), "--metrics",
                            str(metrics), "--device", "cpu", *flags])
    records = [json.loads(line) for line in open(metrics)]
    assert state.step == 2 and all(np.isfinite(r["loss"]) for r in records)
    assert len(state.optimizer.adamw.param_groups) == 2  # image_encoder_lr_mult 3
    if "--pretrained-decoder" in flags:
        assert "pretrained decoder tensors" in caplog.text


@pytest.mark.parametrize("flags", [[], ["--device-data"]], ids=["windows", "device_data"])
def test_distill_from_a_database(recorded, flags, tmp_path):
    root, db, yml = recorded
    out = tmp_path / "student"
    state = distill.main([str(yml), str(root / "teacher"), "-o", str(out), "--db", str(db),
                          "--epochs", "1", "--steps-per-epoch", "2", "--device", "cpu", *flags])
    assert state.step == 2 and load_checkpoint(out)["hyperparams"]["distilled_decoder"] is True


@pytest.mark.parametrize("packed", [False, True], ids=["windows", "packed"])
def test_aux_loss_on_vision_windows_and_off_on_packed(tmp_path, packed, caplog):
    cfg = {**TINY, "aux_cue_head": True, "aux_cue_weight": 0.1, "dummy_task": "vision",
           "num_joints": 6}
    yml = tmp_path / "cue.yaml"
    yml.write_text(yaml.safe_dump(cfg))
    with caplog.at_level(logging.WARNING, logger="soccerdiffusion_tpu_torch"):
        train.main(["-c", str(yml), "--dummy-data", "--epochs", "1", "--steps-per-epoch", "2",
                    "-o", str(tmp_path / "ckpt"), "--metrics", str(tmp_path / "m.jsonl"),
                    "--device", "cpu", *(["--packed"] if packed else [])])
    records = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    warned = "exposes no vision_u labels" in caplog.text
    if packed:
        assert warned and all("aux_cue_loss" not in r for r in records)
    else:
        assert not warned and all(np.isfinite(r["aux_cue_loss"]) for r in records)
        assert records[0]["grad_norms/cue_head"] > 0
