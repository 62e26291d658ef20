"""The port's parallel paths through whole models, on the CPU, against the
JAX package (ranks as in tests/test_torch_parallel.py: one group of four
gloo ranks runs every check):

  * ``attention_impl: "ring"``: the full policy of JAX's TestRingWiring
    (contexts of 100, a 10-step chunk) under data=2 x seq=2 against the JAX
    forward with plain attention (2e-4, as the JAX test), the encoders'
    self-attention on the ring, the decoder's cross-attention head-sharded;
    and one ring train step against one process of the port with plain
    attention (the loss 1e-5 relative, the gradients 1e-5);
  * synchronised BatchNorm: the ResNet18 encoder in float64, train mode,
    one frame per rank on four ranks whose frames differ in scale and
    offset (each rank's own statistics would differ from the batch's by
    far more than the tolerance, which the check shows), against JAX's
    float64 train-mode apply at the whole batch: the output and dx within
    1e-9 of each tensor's largest magnitude (tests/test_torch_resnet.py's
    float64 bound), the gradients (summed over the ranks) and the running
    statistics within 1e-6 of it (one process of the port sits 5e-8 from
    JAX's float64 ones on these frames without any mesh, measured); and
    against one process of the port at the whole batch, in
    float64, every one of those within 1e-12 (the same function: only the
    order of the sums differs);
  * ``train --mesh data=2`` under ``torch.distributed.run`` (two CPU
    processes): one checkpoint, the same per-step losses as one process at
    the same global batch (1e-5 relative), and parameters that load and
    equal the one process's within 1e-5 (the key biases within 2 lr a step);
    then ``distill --mesh data=2`` of that teacher: the same losses as one
    process's distillation (1e-5 relative), one checkpoint.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.models.vision import ResNetImageEncoder as JaxResNet
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.models.vision import make_image_encoder
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

from tests.test_torch_jax_params import port_config, to_torch
from tests.torch_parallel_launch import REPO, free_port, run_ranks, worker_env

pytestmark = pytest.mark.timeout(600)

RING = ModelConfig(num_joints=6, hidden_dim=32, trajectory_prediction_length=10,
                   action_context_length=100, joint_state_context_length=100,
                   imu_context_length=100, use_images=False, use_gamestate=True,
                   num_action_history_encoder_layers=1, num_imu_encoder_layers=1,
                   joint_state_encoder_layers=1, num_decoder_layers=2, attention_impl="xla")
B = 8
HIDDEN, RES, FRAMES = 16, 64, 4
F64_TOL = 1e-9


def ring_batch(b=B):
    rng = np.random.default_rng(0)
    return {"joint_command_history": rng.random((b, 100, 6), np.float32),
            "rotation": rng.random((b, 100, 4), np.float32),
            "joint_state": rng.random((b, 100, 6), np.float32),
            "game_state": np.zeros((b,), np.int32)}


def close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def case():
    batch = ring_batch()
    noisy = np.random.default_rng(1).random((B, 10, 6), np.float32)
    t = np.full((B,), 3, np.int64)
    variables = JaxPolicy(RING).init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()},
                                     jnp.asarray(noisy), jnp.asarray(t, jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(2)
    step = (rng.uniform(0, 2 * np.pi, (B, 10, 6)).astype(np.float32),
            rng.integers(0, 100, (B,)).astype(np.int64),
            rng.standard_normal((B, 10, 6)).astype(np.float32))
    ring_cfg = dataclasses.asdict(port_config(RING, attention_impl="ring"))
    # the ResNet: frame r scaled by (1 + r) and shifted by r / 2, so that
    # each rank's statistics are far from the batch's
    enc = make_image_encoder("resnet18", HIDDEN, RES, use_final_avgpool=True)
    enc_params, enc_stats = random_jax_params(enc, seed=4)
    x = np.random.default_rng(6).standard_normal((FRAMES, RES, RES, 3))
    x = x * (1.0 + np.arange(FRAMES))[:, None, None, None] + 0.5 * np.arange(FRAMES)[:, None, None,
                                                                                     None]
    x = x.astype(np.float32)
    dy = np.random.default_rng(7).standard_normal((FRAMES, HIDDEN)).astype(np.float32)
    checks = [
        ("forward", "policy_forward", dict(cfg=ring_cfg, shape={"data": 2, "seq": 2},
                                           params=params, batch=batch, noisy=noisy, t=t)),
        ("ring_step", "step", dict(cfg=ring_cfg, shape={"data": 2, "seq": 2}, params=params,
                                   batch=batch, target=step[0], t=step[1], noise=step[2])),
        ("sync_bn", "sync_bn", dict(kind="resnet18", hidden=HIDDEN, res=RES, params=enc_params,
                                    stats=enc_stats, x=x, dy=dy, shape={"data": 4})),
    ]
    return dict(batch=batch, noisy=noisy, t=t, variables=variables, params=params, step=step,
                enc_params=enc_params, enc_stats=enc_stats, x=x, dy=dy, checks=checks)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks(case["checks"], 4, tmp_path_factory.mktemp("model_ranks"))


def test_ring_policy_forward_equals_jax(case, ranks):
    jmodel = JaxPolicy(RING)
    want = np.asarray(jmodel.apply(case["variables"], {k: jnp.asarray(v)
                                                        for k, v in case["batch"].items()},
                                   jnp.asarray(case["noisy"]),
                                   jnp.asarray(case["t"], jnp.int32), False))
    for result in ranks:
        got = result["forward"]
        np.testing.assert_allclose(got["out"], want[got["rows"]], rtol=2e-4, atol=2e-4)
    rows = np.concatenate([r["forward"]["rows"] for r in ranks[::2]])
    np.testing.assert_array_equal(rows, np.arange(B))  # data ranks 0, 1 cover the batch


def test_ring_train_step_equals_one_process(case, ranks):
    model = load_jax_params(DiffusionPolicy(port_config(RING)), case["params"])
    opt = make_optimizer(model, 1e-3, 10, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(6))
    target, t, noise = case["step"]
    metrics = step.apply(state, {**to_torch(case["batch"]), "joint_command": torch.from_numpy(target)},
                         torch.from_numpy(t), torch.from_numpy(noise))
    for result in ranks:
        got = result["ring_step"]
        np.testing.assert_allclose(got["loss"], metrics["loss"].item(), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], metrics["grad_norm"].item(), rtol=1e-5)
        for name, p in model.named_parameters():
            if not name.endswith("k_proj.bias"):
                np.testing.assert_allclose(got["grads"][name], p.grad.numpy(), atol=1e-5, rtol=0,
                                           err_msg=name)


@pytest.fixture(scope="module")
def port_resnet64(case):
    """One process of the port, float64, train mode, at the whole batch."""
    enc = make_image_encoder("resnet18", HIDDEN, RES, use_final_avgpool=True,
                             dtype=torch.float64).double()
    load_jax_params(enc, case["enc_params"], case["enc_stats"]).train()
    x = torch.from_numpy(case["x"]).double().requires_grad_(True)
    out = enc(x)
    (out * torch.from_numpy(case["dy"]).double()).sum().backward()
    return (out.detach().numpy(), {n: b.numpy() for n, b in enc.named_buffers()},
            {n: p.grad.numpy() for n, p in enc.named_parameters()}, x.grad.numpy())


@pytest.fixture(scope="module")
def jax_resnet64(case):
    with jax.enable_x64(True):
        j64 = JaxResNet(HIDDEN, (2, 2, 2, 2), False, use_final_avgpool=True, dtype=jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)

        def loss(p, xx):
            out, mutated = j64.apply({"params": p, "batch_stats": f64(case["enc_stats"])}, xx, True,
                                     mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(case["dy"], jnp.float64)), (out, mutated["batch_stats"])

        (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                                 has_aux=True))(
            f64(case["enc_params"]), jnp.asarray(case["x"], jnp.float64))
        return jax.tree.map(np.asarray, (out, stats, gp, gx))


def test_synchronised_batchnorm_equals_jax_float64(case, ranks, jax_resnet64, port_resnet64):
    out, stats, gp, gx = jax_resnet64
    enc = make_image_encoder("resnet18", HIDDEN, RES, use_final_avgpool=True,
                             dtype=torch.float64).double()
    grads = {n: p.detach().numpy() for n, p in load_jax_params(enc, gp, stats).named_parameters()}
    want_stats = {n: b.numpy() for n, b in enc.named_buffers()}
    one_out, one_stats, one_grads, one_dx = port_resnet64
    for rank, result in enumerate(ranks):
        got = result["sync_bn"]["synced"]
        close(got["out"], out[rank:rank + 1], F64_TOL, f"rank {rank} out")
        close(got["dx"], gx[rank:rank + 1], F64_TOL, f"rank {rank} dx")
        close(got["out"], one_out[rank:rank + 1], 1e-12, f"rank {rank} out, one process")
        close(got["dx"], one_dx[rank:rank + 1], 1e-12, f"rank {rank} dx, one process")
        for name, want in grads.items():
            close(got["grads"][name], want, 1e-6, f"rank {rank} grad {name}")
            close(got["grads"][name], one_grads[name], 1e-12, f"rank {rank} grad {name}, one")
        for key, value in want_stats.items():
            close(got["buffers"][key], value, 1e-6, f"rank {rank} {key}")
            close(got["buffers"][key], one_stats[key], 1e-12, f"rank {rank} {key}, one")
        # each rank's own statistics would give another output
        alone = result["sync_bn"]["alone"]
        assert np.abs(alone["out"] - got["out"]).max() > 1e3 * F64_TOL * np.abs(out).max()


TINY = {"num_joints": 6, "hidden_dim": 32, "trajectory_prediction_length": 5,
        "action_context_length": 12, "joint_state_context_length": 12, "imu_context_length": 12,
        "use_images": False, "use_gamestate": True, "num_action_history_encoder_layers": 1,
        "num_imu_encoder_layers": 1, "joint_state_encoder_layers": 1, "num_decoder_layers": 1,
        "batch_size": 8, "lr": 1e-3, "log_every": 1, "num_normalization_samples": 50,
        "train_denoising_timesteps": 100}


def read_losses(path):
    return [json.loads(line)["loss"] for line in path.read_text().splitlines()]


def test_train_cli_under_torchrun_equals_one_process(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY))
    common = ["-c", str(cfg), "--dummy-data", "--device", "cpu", "--epochs", "1",
              "--steps-per-epoch", "2"]
    run = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
           f"--master_port={free_port()}", "-m", "soccerdiffusion_tpu_torch.training.train",
           *common, "--mesh", "data=2", "-o", str(tmp_path / "two"), "--metrics",
           str(tmp_path / "two.jsonl")]
    proc = subprocess.run(run, cwd=REPO, env=worker_env(), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    one = [sys.executable, "-m", "soccerdiffusion_tpu_torch.training.train", *common,
           "-o", str(tmp_path / "one"), "--metrics", str(tmp_path / "one.jsonl")]
    proc = subprocess.run(one, cwd=REPO, env=worker_env(), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    two_losses, one_losses = read_losses(tmp_path / "two.jsonl"), read_losses(tmp_path / "one.jsonl")
    assert len(two_losses) == len(one_losses) == 2  # rank 0 alone wrote the metrics
    np.testing.assert_allclose(two_losses, one_losses, rtol=1e-5)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == ["one", "two"]
    two, one = load_checkpoint(tmp_path / "two"), load_checkpoint(tmp_path / "one")
    assert two["step"] == one["step"] == 2 and two["hyperparams"] == one["hyperparams"]
    model = DiffusionPolicy(port_config(ModelConfig(**{k: v for k, v in TINY.items()
                                                       if k in ModelConfig.__dataclass_fields__})))
    model.load_state_dict(two["params"])
    # the key biases' gradient is zero in exact arithmetic: AdamW turns its
    # float32 noise into a step of ~lr of either sign (tests/test_torch_training.py)
    noise_bound = 2 * sum(lr_at_step(TINY["lr"], 2, k) for k in range(2))
    for name, value in one["params"].items():
        tol = noise_bound if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(two["params"][name].numpy(), value.numpy(), atol=tol, rtol=0,
                                   err_msg=name)

    # distil the one-process teacher, on two ranks and in one process
    distill = ["-m", "soccerdiffusion_tpu_torch.training.distill", str(cfg), str(tmp_path / "one"),
               "--dummy-data", "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "2",
               "--student-steps", "2"]
    torchrun = [*run[:4], f"--master_port={free_port()}"]
    for name, prefix in (("two_s", torchrun), ("one_s", [sys.executable])):
        extra = ["--mesh", "data=2"] if name == "two_s" else []
        proc = subprocess.run([*prefix, *distill, *extra, "-o", str(tmp_path / name), "--metrics",
                               str(tmp_path / f"{name}.jsonl")], cwd=REPO, env=worker_env(),
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-4000:]
    two_losses, one_losses = read_losses(tmp_path / "two_s.jsonl"), read_losses(tmp_path / "one_s.jsonl")
    assert len(two_losses) == len(one_losses) == 2
    np.testing.assert_allclose(two_losses, one_losses, rtol=1e-5)
    assert load_checkpoint(tmp_path / "two_s")["step"] == 2
