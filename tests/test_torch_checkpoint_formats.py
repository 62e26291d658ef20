"""The JAX package's msgpack checkpoints read by the port
(``utils/flax_msgpack.py``, ``training/checkpoint.py``), float32 on the CPU:

  * ``flax_msgpack.pack`` equals ``flax.serialization.msgpack_serialize``
    byte for byte (float32, bfloat16, int32 and scalar leaves, complex,
    nested maps, a chunked array), and ``restore`` returns what
    ``msgpack_restore`` does, on those trees and on checkpoints the JAX
    package wrote;
  * checkpoints the JAX package writes with its own ``save_checkpoint``
    after two steps of its own jitted trainer: the proprioceptive model
    (tests/test_torch_jax_params.py's SMALL at hidden 32, one decoder layer), the same run with its EMA, a
    ``distilled_decoder`` student, and a ResNet18 model with
    ``batch_stats``. Each serves, through the port's ``load_policy`` and
    sampler, the chunks the JAX package's ``load_policy_checkpoint`` and
    sampler serve on the same noise, within 1e-5 of the chunk's scale
    (float32 summation order over a few denoiser passes);
  * a resume: the JAX package runs 3 more steps from its EMA checkpoint,
    the port 3 steps from the same checkpoint on the same timesteps and
    noise (the JAX step's draws); losses within 1e-5 relative, parameters
    and EMA within 1e-5 (the key biases, whose gradient is zero in exact
    arithmetic, within 2 lr a step, as tests/test_torch_training.py);
  * ``train.py --checkpoint`` / ``--pretrained-decoder`` on a JAX checkpoint;
  * the refusals: an orbax checkpoint, a truncated ``state.msgpack``, an
    unknown extension type, trailing bytes, a ``flat_optimizer`` checkpoint,
    a leftover leaf, neither or both files.
"""

import dataclasses
import json
import shutil
from types import SimpleNamespace

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccerdiffusion_tpu.config import Config as JaxConfig
from soccerdiffusion_tpu.config import TrainConfig as JaxTrainConfig
from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.inference.sampler import make_chunk_sampler as jax_make_chunk_sampler
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.training import checkpoint as jax_checkpoint
from soccerdiffusion_tpu.training import trainer as jax_trainer
from soccerdiffusion_tpu.training.flat_optim import flat_wrap
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference.sampler import make_chunk_sampler
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training import train
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, load_policy
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils import flax_msgpack
from soccerdiffusion_tpu_torch.utils.jax_params import _flatten, flax_init_params, flax_parameters
from tests.test_torch_evaluation import JitPolicy
from tests.test_torch_jax_params import SMALL, make_batch, port_config, to_jax, to_torch

B, STEPS, T_TRAIN, LR, TOTAL, CLIP, DECAY = 3, 3, 100, 1e-3, 10, 0.5, 0.9
SERVE_TOL = 1e-5
# the h128 architecture cut to hidden 32 and one decoder layer (compile time)
TINY = dataclasses.replace(SMALL, hidden_dim=32, num_decoder_layers=1)
# default.yaml's ResNet18 frame encoder at 32 px over 2 frames
RESNET = dataclasses.replace(TINY, use_images=True, image_encoder_type="resnet18",
                             image_resolution=32, image_context_length=2,
                             image_use_final_avgpool=False)


def hyperparams(cfg, **changes) -> dict:
    train_cfg = JaxTrainConfig(lr=LR, train_denoising_timesteps=T_TRAIN, ema_decay=DECAY,
                               grad_clip_norm=CLIP, distill_teacher_inference_steps=STEPS)
    return {**JaxConfig(model=cfg, train=train_cfg).to_dict(), **changes}


def train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = make_batch(cfg, B, rng)
    batch["joint_command"] = rng.uniform(0, 2 * np.pi, (B, cfg.trajectory_prediction_length,
                                                        cfg.num_joints)).astype(np.float32)
    return batch


class JaxRun:
    """The JAX package's trainer on ``cfg``: jitted steps from its own
    create_train_state (EMA on, clipping), the checkpoint normaliser."""

    def __init__(self, cfg, ema: bool):
        self.cfg, self.model = cfg, JaxPolicy(cfg)
        self.optimizer = jax_trainer.make_optimizer(LR, TOTAL, grad_clip_norm=CLIP)
        self.norm = JaxNormalizer(mean=jnp.linspace(2.5, 3.5, cfg.num_joints),
                                  std=jnp.linspace(0.5, 1.5, cfg.num_joints))
        self.step_fn = jax_trainer.make_train_step(
            self.model, jax_make_schedule(T_TRAIN), self.optimizer, self.norm, donate=False,
            ema_decay=DECAY if ema else 0.0)
        self.ema = ema

    def fresh_state(self):
        """The JAX TrainState of flax's initialisers (drawn with numpy:
        ``model.init`` op by op takes seconds on the CPU)."""
        params, stats = flax_init_params(DiffusionPolicy(port_config(self.cfg)), seed=0)
        params, stats = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
        return jax_trainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=self.optimizer.init(params),
            ema_params=jax.tree.map(jnp.copy, params) if self.ema else {})

    def steps(self, state, first: int, n: int):
        losses = []
        for i in range(first, first + n):
            state, metrics = self.step_fn(state, to_jax(train_batch(self.cfg, 10 + i)), 5)
            losses.append(float(metrics["loss"]))
        return state, losses

    def draws(self, step: int):
        """The timesteps and noise the JAX step draws at ``step``."""
        rng = jax.random.fold_in(jax.random.key(5), step)
        t_key, noise_key, _ = jax.random.split(rng, 3)
        shape = (B, self.cfg.trajectory_prediction_length, self.cfg.num_joints)
        return (np.asarray(jax.random.randint(t_key, (B,), 0, T_TRAIN)),
                np.asarray(jax.random.normal(noise_key, shape, dtype=jnp.float32)))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX-written checkpoints after two steps of the JAX trainer:
    {"small", "ema", "student", "resnet"} -> directory, and the runs."""
    root = tmp_path_factory.mktemp("jax_checkpoints")
    small = JaxRun(TINY, ema=True)
    state, _ = small.steps(small.fresh_state(), 0, 2)
    save = lambda name, st, hp: jax_checkpoint.save_checkpoint(root / name, st, small.norm, hp, 0)
    save("ema", state, hyperparams(TINY))
    save("small", state.replace(ema_params={}), hyperparams(TINY))
    save("student", state.replace(ema_params={}), hyperparams(TINY, distilled_decoder=True))
    resnet = JaxRun(RESNET, ema=False)
    rstate, _ = resnet.steps(resnet.fresh_state(), 0, 2)
    jax_checkpoint.save_checkpoint(root / "resnet", rstate, resnet.norm, hyperparams(RESNET), 0)
    return {"dirs": {n: root / n for n in ("small", "ema", "student", "resnet")},
            "runs": {"small": small, "resnet": resnet}, "root": root}


# ------------------------------------------------------------------ msgpack

def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _as_torch_bf16(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


TREES = {
    "float32": lambda r: {"w": r.normal(size=(3, 4)).astype(np.float32)},
    "bfloat16": lambda r: {"w": _bf16(r.normal(size=(2, 5)))},
    "int32": lambda r: {"i": np.arange(-3, 9, dtype=np.int32).reshape(3, 4)},
    "scalars": lambda r: {"s": np.float32(2.5), "i": np.int32(-7), "step": np.zeros((), np.int32),
                          "b": np.bool_(True), "x": 1.25, "n": 300, "m": -40000, "h": 2 ** 40,
                          "none": None, "t": True, "str": "hyper" * 10},
    "complex": lambda r: {"c": 1.5 - 2j, "a": np.array([1 + 1j, 2], np.complex64)},
    "nested": lambda r: {"b": {"z": {"k": r.normal(size=(2,)).astype(np.float32)}, "e": {}},
                         "a": [1, 2.0, "x"], "empty": np.zeros((0, 3), np.float32)},
    "chunked": lambda r: {"big": r.normal(size=(41,)).astype(np.float64),
                          "bf": _bf16(r.normal(size=(23,))), "small": np.ones(2, np.float32)},
}


def _leaves_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _leaves_equal(g, w)
    elif isinstance(got, torch.Tensor):
        assert str(np.asarray(want).dtype) == "bfloat16" and got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.array_equal(np.asarray(got), np.asarray(want))
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", list(TREES))
def test_pack_and_restore_match_flax(name, monkeypatch):
    if name == "chunked":  # 16-byte chunks: every array over that splits
        monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 16)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 16)
    tree = TREES[name](np.random.default_rng(3))
    want = flax_serialization.msgpack_serialize(tree)
    if name == "chunked":
        assert b"__msgpack_chunked_array__" in want
    ours = jax.tree.map(lambda a: _as_torch_bf16(a) if str(getattr(a, "dtype", "")) == "bfloat16"
                        else a, tree)
    assert flax_msgpack.pack(ours) == want
    _leaves_equal(flax_msgpack.restore(want), flax_serialization.msgpack_restore(want))


def test_restore_matches_flax_on_jax_checkpoints(checkpoints):
    for name in ("ema", "resnet"):
        data = (checkpoints["dirs"][name] / "state.msgpack").read_bytes()
        want = flax_serialization.msgpack_restore(data)
        got = flax_msgpack.restore(data)
        _leaves_equal(got, want)
        assert flax_msgpack.pack(got) == data


def test_decoder_refusals():
    data = flax_msgpack.pack({"a": np.ones(3, np.float32), "b": 1})
    with pytest.raises(ValueError, match=r"truncated: .* at offset"):
        flax_msgpack.restore(data[:-5])
    with pytest.raises(ValueError, match=r"2 trailing bytes at offset %d" % len(data)):
        flax_msgpack.restore(data + b"\x00\x01")
    with pytest.raises(ValueError, match="unknown msgpack extension type 9 at offset 3"):
        flax_msgpack.restore(b"\x81\xa1a\xd4\x09\x00")
    with pytest.raises(ValueError, match="unknown msgpack type byte 0xc1 at offset 0"):
        flax_msgpack.restore(b"\xc1")
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.pack({"a": (1, 2)})


def test_chip_smoke_writes_the_jax_package_bytes(checkpoints, tmp_path):
    """chip_smoke.py's JAX-format writer (the card's machine has no JAX)
    writes the bytes the JAX package's save_checkpoint writes for the same
    state: optax.adamw's chain under the one-cycle schedule, EMA, step."""
    import chip_smoke

    run = checkpoints["runs"]["small"]
    params = jax.tree.map(np.asarray, run.fresh_state().params)
    optimizer = jax_trainer.make_optimizer(LR, TOTAL)
    state = jax_trainer.TrainState(step=jnp.asarray(120, jnp.int32), params=params,
                                   batch_stats={}, opt_state=optimizer.init(params),
                                   ema_params=params)
    jax_checkpoint.save_checkpoint(tmp_path / "jax", state, run.norm, hyperparams(TINY), 3)
    zeros = jax.tree.map(np.zeros_like, params)
    chip_smoke.write_jax_checkpoint(
        tmp_path / "smoke", hyperparams(TINY), params,
        (np.asarray(run.norm.mean), np.asarray(run.norm.std)),
        opt_state=chip_smoke.jax_opt_state(zeros, zeros, 0), ema=params, step=120, epoch=3)
    for name in ("state.msgpack", "hyperparams.json"):
        assert (tmp_path / "smoke" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# ------------------------------------------------------------------ serving

def serve_pair(path, prefer_ema=True, seed=11):
    """(the JAX package's chunks, the port's) from the checkpoint at
    ``path`` on the same batch and noise."""
    hp, variables, jnorm, steps, distilled = jax_checkpoint.load_policy_checkpoint(
        path, prefer_ema=prefer_ema)
    jcfg = JaxConfig.from_dict(hp).model
    batch = make_batch(jcfg, B, np.random.default_rng(seed))
    rng = jax.random.key(seed)
    want = jax_make_chunk_sampler(JitPolicy(jcfg), jax_make_schedule(T_TRAIN), jnorm, steps,
                                  distilled=distilled, jit=False)(variables, to_jax(batch), rng)
    noise = np.asarray(jax.random.normal(
        rng, (B, jcfg.trajectory_prediction_length, jcfg.num_joints), dtype=jnp.float32))
    model, norm, psteps, pdistilled, phyper = load_policy(path, "cpu", prefer_ema=prefer_ema)
    assert (psteps, pdistilled, phyper) == (steps, distilled, hp)
    got = make_chunk_sampler(model, make_schedule(T_TRAIN), norm, psteps, pdistilled)(
        to_torch(batch), torch.from_numpy(noise.copy()))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", ["small", "ema", "student", "resnet"])
def test_jax_checkpoint_serves_the_jax_chunks(checkpoints, name):
    want, got = serve_pair(checkpoints["dirs"][name])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SERVE_TOL * max(1.0, np.abs(want).max()), rtol=0)


def test_ema_is_served_and_batch_stats_are_the_buffers(checkpoints):
    dirs = checkpoints["dirs"]
    ema, raw = serve_pair(dirs["ema"])[1], serve_pair(dirs["ema"], prefer_ema=False)[1]
    assert np.abs(ema - raw).max() > 1e-3  # the EMA, not the raw parameters, was served
    raw_tree = flax_serialization.msgpack_restore((dirs["resnet"] / "state.msgpack").read_bytes())
    stats = _flatten(raw_tree["batch_stats"])
    model = load_policy(dirs["resnet"], "cpu")[0]
    buffers = dict(model.named_buffers())
    assert len(stats) == 40
    for path, value in stats.items():
        name = path.replace("/", ".").replace("layer_", "layers.")
        assert torch.equal(buffers[name], torch.from_numpy(np.array(value))), path
    assert not np.array_equal(stats[next(iter(stats))], np.zeros_like(stats[next(iter(stats))]))


# ------------------------------------------------------------------ resume

def test_resume_matches_the_jax_trainer(checkpoints):
    run, path = checkpoints["runs"]["small"], checkpoints["dirs"]["ema"]
    template = run.fresh_state()
    restored = jax_checkpoint.load_checkpoint(path, template)["state"]
    jstate, jlosses = run.steps(restored, 2, STEPS)

    model = DiffusionPolicy(port_config(TINY))
    opt = make_optimizer(model, LR, TOTAL, grad_clip_norm=CLIP)
    state = create_train_state(model, opt, ema=True)
    ckpt = load_checkpoint(path, state)
    assert state.step == 2 and ckpt["format"] == "soccerdiffusion_tpu/msgpack"
    moments = opt.adamw.state_dict()["state"]
    assert all(float(m["step"]) == 2.0 for m in moments.values())
    # in the parameters' layout (fused AdamW on the card refuses other strides)
    for p, m in zip(opt.params, moments.values()):
        assert all(m[k].stride() == p.stride() for k in ("exp_avg", "exp_avg_sq"))
    step = make_train_step(model, make_schedule(T_TRAIN), opt, ckpt["norm"], ema_decay=DECAY)
    losses = []
    for i in range(2, 2 + STEPS):
        t, noise = run.draws(i)
        metrics = step.apply(state, to_torch(train_batch(TINY, 10 + i)), torch.from_numpy(t),
                             torch.from_numpy(noise))
        losses.append(metrics["loss"].item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    assert state.step == 2 + STEPS

    probe = DiffusionPolicy(port_config(TINY))
    want = {}
    for tree, what in ((jstate.params, "params"), (jstate.ema_params, "ema")):
        want[what] = flax_parameters(probe, jax.tree.map(np.asarray, tree))
    noise_bound = 2 * sum(lr_at_step(LR, TOTAL, k) for k in range(2 + STEPS))
    for name, p in model.named_parameters():
        tol = noise_bound if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(p.detach().numpy(), want["params"][name].numpy(), atol=tol,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want["ema"][name].numpy(), atol=tol,
                                   rtol=0, err_msg=f"ema {name}")


def test_train_cli_resumes_and_takes_a_pretrained_decoder(checkpoints, tmp_path):
    dirs = checkpoints["dirs"]
    out = tmp_path / "resumed"
    state = train.main(["-p", str(dirs["ema"]), "--dummy-data", "--epochs", "2",
                        "--steps-per-epoch", "1", "-o", str(out), "--device", "cpu"])
    assert state.step == 3 and load_checkpoint(out)["format"] == "soccerdiffusion_tpu_torch/1"
    model = DiffusionPolicy(port_config(TINY))
    copied = train.load_pretrained_decoder(model, str(dirs["small"]))
    raw = load_checkpoint(dirs["small"])["params"]
    assert copied and all(torch.equal(model.get_parameter(n), raw[n]) for n in copied)


# ------------------------------------------------------------------ refusals

def test_format_is_chosen_by_the_files_and_refusals(checkpoints, tmp_path):
    src = checkpoints["dirs"]["small"]
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "hyperparams.json").write_text(json.dumps(
        {"hyperparams": hyperparams(TINY), "current_epoch": 0, "backend": "orbax"}))
    with pytest.raises(ValueError, match="orbax checkpoint .* orbax and tensorstore, which import jax"):
        load_checkpoint(orbax)
    with pytest.raises(FileNotFoundError, match="neither state.pt .* nor state.msgpack"):
        load_checkpoint(tmp_path)

    cut = tmp_path / "truncated"
    shutil.copytree(src, cut)
    data = (src / "state.msgpack").read_bytes()
    (cut / "state.msgpack").write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match=r"state.msgpack.*truncated.*at offset"):
        load_checkpoint(cut)

    both = tmp_path / "both"
    shutil.copytree(src, both)
    torch.save({"format": "something else"}, both / "state.pt")
    with pytest.raises(ValueError, match="both state.pt and state.msgpack"):
        load_checkpoint(both)
    (both / "state.msgpack").unlink()
    with pytest.raises(ValueError, match="state.pt is not a soccerdiffusion_tpu_torch/1 checkpoint"):
        load_checkpoint(both)

    leftover = tmp_path / "leftover"
    shutil.copytree(src, leftover)
    tree = flax_msgpack.restore(data)
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    (leftover / "state.msgpack").write_bytes(flax_msgpack.pack(tree))
    with pytest.raises(KeyError, match="extra/kernel"):
        load_checkpoint(leftover)


def test_flat_optimizer_checkpoint_is_refused_on_resume(checkpoints, tmp_path):
    run = checkpoints["runs"]["small"]
    params = run.fresh_state().params
    opt_state = flat_wrap(optax.adamw(1e-3)).init(params)
    state = SimpleNamespace(step=np.zeros((), np.int32), params=params, batch_stats={},
                            opt_state=opt_state)
    jax_checkpoint.save_checkpoint(tmp_path / "flat", state, run.norm,
                                   hyperparams(TINY, flat_optimizer=True), 0)
    load_policy(tmp_path / "flat", "cpu")  # serving needs no optimizer state
    model = DiffusionPolicy(port_config(TINY))
    state = create_train_state(model, make_optimizer(model, LR, TOTAL))
    with pytest.raises(ValueError, match="flat_optimizer"):
        load_checkpoint(tmp_path / "flat", state)
