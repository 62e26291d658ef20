"""The port's training CLI (training/train.py) on the CPU: a few steps on
the synthetic data with the fused knobs on give finite losses, write a
checkpoint that loads back equal, and resume from it; a ``train.mesh_shape``
over more ranks than the process group holds raises (one process here), a
one-device mesh trains."""

import json

import numpy as np
import pytest
import torch
import yaml

from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.training import train
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint

CONFIG = dict(
    num_joints=6, hidden_dim=64, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=12, imu_context_length=12, use_images=False, use_gamestate=True,
    num_action_history_encoder_layers=2, num_imu_encoder_layers=1, joint_state_encoder_layers=1,
    num_decoder_layers=2, batch_size=4, num_normalization_samples=50, log_every=1, lr=1e-3,
    ema_decay=0.99, encoder_fused_stack=True, decoder_fused_block=True)


@pytest.fixture
def run(tmp_path):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(yaml.safe_dump(CONFIG))

    def go(*extra):
        return train.main(["-c", str(cfg), "--dummy-data", "--steps-per-epoch", "3",
                           "-o", str(tmp_path / "ckpt"), "--metrics", str(tmp_path / "m.jsonl"),
                           "--device", "cpu", *extra])

    return go, tmp_path


def test_trains_and_checkpoint_round_trips(run):
    go, tmp = run
    state = go("--epochs", "1")
    records = [json.loads(line) for line in (tmp / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["steps_per_sec"] > 0 for r in records)
    assert "grad_norms/diffusion_action_generator" in records[0]
    ckpt = load_checkpoint(tmp / "ckpt")
    assert ckpt["current_epoch"] == 0 and ckpt["step"] == 3 and ckpt["hyperparams"] == CONFIG | {"epochs": 1}
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(ckpt["params"][name], p, rtol=0, atol=0)
    for name, e in state.ema.items():
        torch.testing.assert_close(ckpt["ema"][name], e, rtol=0, atol=0)
    saved = ckpt["optimizer"]["state"]
    live = state.optimizer.adamw.state_dict()["state"]
    for k in live:
        torch.testing.assert_close(saved[k]["exp_avg_sq"], live[k]["exp_avg_sq"], rtol=0, atol=0)


def test_resume_continues_from_the_checkpoint(run):
    go, tmp = run
    go("--epochs", "1")
    state = go("--epochs", "2", "-p", str(tmp / "ckpt"))
    assert state.step == 6 and load_checkpoint(tmp / "ckpt")["current_epoch"] == 1


def test_sqlite_data_is_not_ported(run, monkeypatch):
    """Without --dummy-data the CLI reads the SQLite database at --db, else at
    DB_PATH; a missing one raises naming its path, before any work (the name
    is kept from when the SQLite source raised; tests/test_torch_train_options.py
    trains from a database)."""
    import soccerdiffusion_tpu_torch

    go, tmp = run
    monkeypatch.setattr(soccerdiffusion_tpu_torch, "DB_PATH", str(tmp / "default.sqlite3"))
    for flags, path in (([], tmp / "default.sqlite3"), (["--db", str(tmp / "given.sqlite3")],
                                                        tmp / "given.sqlite3")):
        with pytest.raises(FileNotFoundError, match=f"no SQLite dataset at {path}"):
            train.main(["-c", str(tmp / "small.yaml"), "-o", str(tmp / "x"), "--device", "cpu",
                        *flags])
    assert not (tmp / "x").exists()


def test_default_device_is_the_card(run):
    """Without --device the CLI trains on CUDA, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    _, tmp = run
    assert train.RunOptions().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["-c", str(tmp / "small.yaml"), "--dummy-data", "-o", str(tmp / "x")])


# train.mesh_shape: the JAX trainer builds its device mesh from it; the port
# lays the process group's ranks out on it (parallel/mesh.py), so a mesh over
# more ranks than the process holds (one here) raises, and {} or axes of size 1
# train (several ranks: tests/test_torch_parallel_models.py)
MULTI_DEVICE_MESHES = {"data8": {"data": 8}, "data4-model2": {"data": 4, "model": 2},
                       "data2-model1": {"data": 2, "model": 1}}


@pytest.mark.parametrize("mesh", MULTI_DEVICE_MESHES.values(), ids=MULTI_DEVICE_MESHES.keys())
def test_multi_device_mesh_is_refused(mesh, tmp_path):
    config = Config.from_dict({**CONFIG, "mesh_shape": mesh})
    opts = train.RunOptions(output=str(tmp_path / "ckpt"), dummy_data=True, epochs=1,
                            steps_per_epoch=1, device="cpu")
    need = int(np.prod(list(mesh.values())))
    with pytest.raises(ValueError, match=f"needs {need} ranks, have 1"):
        train.train(config, opts)
    path = tmp_path / "mesh.yaml"
    path.write_text(yaml.safe_dump({**CONFIG, "mesh_shape": mesh}))
    with pytest.raises(ValueError, match=f"needs {need} ranks, have 1"):
        train.main(["--config", str(path), "--dummy-data", "--steps-per-epoch", "1",
                    "-o", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("mesh", [{}, {"data": 1}, {"data": 1, "model": 1}],
                         ids=["empty", "data1", "data1-model1"])
def test_one_device_mesh_trains(mesh, tmp_path):
    path = tmp_path / "mesh.yaml"
    path.write_text(yaml.safe_dump({**CONFIG, "mesh_shape": mesh}))
    state = train.main(["--config", str(path), "--dummy-data", "--epochs", "1",
                        "--steps-per-epoch", "2", "-o", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert state.step == 2
    assert load_checkpoint(tmp_path / "ckpt")["hyperparams"]["mesh_shape"] == mesh


def test_metrics_carry_mfu_against_the_nominal_cpu_peak(run, caplog):
    """Every metrics line has ``mfu`` beside ``steps_per_sec``: the meter's
    share of the CPU's nominal 1e11 FLOP/s (utils/profiling.py), as the JAX
    trainer's lines have; the step's FLOPs are logged once."""
    from soccerdiffusion_tpu_torch.utils.profiling import CPU_PEAK_FLOPS

    go, tmp = run
    with caplog.at_level("INFO", logger="soccerdiffusion_tpu_torch"):
        go("--epochs", "1")
    lines = [r.getMessage() for r in caplog.records if "train step FLOPs" in r.getMessage()]
    assert len(lines) == 1, lines
    flops = int(lines[0].rsplit("(", 1)[1].rstrip(")"))
    assert flops > 0
    records = [json.loads(line) for line in (tmp / "m.jsonl").read_text().splitlines()]
    assert all(0 < r["mfu"] < 1 for r in records)
    # the first window is the meter's only one so far: the same steps over the same time
    assert records[0]["mfu"] == pytest.approx(flops * records[0]["steps_per_sec"] / CPU_PEAK_FLOPS,
                                              rel=1e-2)


def test_mfu_is_null_without_a_peak(run, monkeypatch):
    """On a card with no published peak the metrics lines carry ``"mfu": null``,
    never a CPU figure."""
    go, tmp = run
    monkeypatch.setattr(train, "device_peak_flops", lambda device, dtype: None)
    go("--epochs", "1")
    records = [json.loads(line) for line in (tmp / "m.jsonl").read_text().splitlines()]
    assert records and all(r["mfu"] is None for r in records)
