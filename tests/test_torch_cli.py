"""The port's CLI on the CPU: the ``db`` verbs (a database written by either
package read by the other), the verbs handed to their modules (train ->
distill -> report -> plot on a tiny "vision" config), ``serve`` on the
simulated plant and over UDP, the recording verbs through the port's
``ingest/`` (exit 0; tests/test_torch_ingest*.py hold them to the JAX
package), and the PNGs of ``plot`` and ``db plot-window``."""

import logging
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from soccerdiffusion_tpu import cli as jcli
from soccerdiffusion_tpu.config import Config as JaxConfig
from soccerdiffusion_tpu.data import WindowedDataset as JaxWindowed
from soccerdiffusion_tpu_torch import cli
from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data import WindowedDataset
from soccerdiffusion_tpu_torch.data.migrations import LATEST_VERSION, schema_version
from soccerdiffusion_tpu_torch.data.schema import connect
from soccerdiffusion_tpu_torch.inference.realtime import SimulatedRobotIO
from soccerdiffusion_tpu_torch.inference.transport import UdpRobotServer

REPO = Path(__file__).resolve().parent.parent
PNG = b"\x89PNG\r\n\x1a\n"

# examples/quality_ledger.py --fast --vision as a YAML
TINY = {
    "num_joints": 20, "hidden_dim": 32, "trajectory_prediction_length": 10,
    "action_context_length": 20, "joint_state_context_length": 20, "imu_context_length": 20,
    "num_action_history_encoder_layers": 1, "num_imu_encoder_layers": 1,
    "joint_state_encoder_layers": 1, "num_decoder_layers": 1, "use_images": True,
    "use_gamestate": True, "image_encoder_type": "vit", "image_sequence_encoder_type": "transformer",
    "num_image_sequence_encoder_layers": 1, "image_context_length": 2, "image_resolution": 32,
    "vit_patch_size": 8, "vit_width": 32, "vit_depth": 1, "encoder_patch_size": 1,
    "train_denoising_timesteps": 50, "distill_teacher_inference_steps": 5, "batch_size": 16,
    "lr": 1.0e-3, "epochs": 1, "dummy_task": "vision", "num_normalization_samples": 50,
}
PROPRIO = {**TINY, "use_images": False}


def db_windows(path, package):
    cfg = (JaxConfig.from_dict(PROPRIO) if package == "jax" else Config.from_dict(PROPRIO)).model
    ds = (JaxWindowed if package == "jax" else WindowedDataset).from_sqlite(str(path), cfg)
    return [ds[i] for i in (0, len(ds) // 2, len(ds) - 1)], len(ds)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_db_verbs_write_a_database_the_other_package_reads(tmp_path, writer):
    db = str(tmp_path / "db.sqlite3")
    main = cli.main if writer == "port" else jcli.main
    assert main(["db", "create-schema", "--db", db]) == 0
    assert main(["db", "dummy-data", "-n", "2", "-s", "80", "-i", "10", "--db", db]) == 0
    assert main(["db", "migrate", "--db", db]) == 0
    conn = connect(db, read_only=True)
    try:
        assert schema_version(conn) == LATEST_VERSION
    finally:
        conn.close()
    (want, n_jax), (got, n_port) = db_windows(db, "jax"), db_windows(db, "port")
    assert n_jax == n_port == 2 * (80 - 10)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_the_module_runs_as_a_program(tmp_path):
    db = tmp_path / "db.sqlite3"
    proc = subprocess.run([sys.executable, "-m", "soccerdiffusion_tpu_torch.cli", "db",
                           "create-schema", "--db", str(db)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert db.is_file() and "schema created" in proc.stderr


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A teacher (3 steps) and a 1-step student (2 steps) through `train` and
    `distill`, handed to their modules."""
    tmp = tmp_path_factory.mktemp("ckpt")
    yml = tmp / "tiny.yaml"
    yml.write_text(yaml.safe_dump(TINY))
    teacher, student = tmp / "teacher", tmp / "student"
    common = ["--dummy-data", "--epochs", "1", "--device", "cpu"]
    assert cli.main(["train", "-c", str(yml), "-o", str(teacher), "--steps-per-epoch", "3",
                     *common]) == 0
    assert cli.main(["distill", str(yml), str(teacher), "-o", str(student), "--student-steps",
                     "1", "--steps-per-epoch", "2", *common]) == 0
    return tmp, teacher, student


def test_report_is_handed_to_its_module(checkpoints):
    tmp, teacher, student = checkpoints
    out = tmp / "report"
    assert cli.main(["report", "--teacher", str(teacher), "--student", str(student),
                     "--dummy-data", "--windows", "8", "--chunks", "1", "--batch-size", "4",
                     "--out", str(out), "--device", "cpu"]) == 0
    md = out.with_suffix(".md").read_text()
    assert "| student | distilled1 |" in md and "Bayes-oracle calibration" in md


def test_plot_writes_pngs(checkpoints, tmp_path):
    _, teacher, _ = checkpoints
    assert cli.main(["plot", str(teacher), "--dummy-data", "--num-samples", "2", "-o",
                     str(tmp_path), "--device", "cpu"]) == 0
    for s in range(2):
        assert (tmp_path / f"sample_{s}.png").read_bytes()[:8] == PNG


def test_db_plot_window_writes_a_png(tmp_path):
    yml = tmp_path / "tiny.yaml"
    yml.write_text(yaml.safe_dump(TINY))
    out = tmp_path / "window.png"
    assert cli.main(["db", "plot-window", "3", str(out), "--config", str(yml),
                     "--dummy-data"]) == 0
    assert out.read_bytes()[:8] == PNG
    assert cli.main(["db", "plot-window", "10000000", str(out), "--config", str(yml),
                     "--dummy-data"]) == 1


def serve_args(ckpt, *extra):
    return cli.build_parser().parse_args(["serve", str(ckpt), "--device", "cpu", "--duration",
                                          "1", *extra])


@pytest.mark.parametrize("which", ["teacher", "student"])
def test_serve_drives_the_simulated_plant(checkpoints, which):
    _, teacher, student = checkpoints
    stats = cli.serve(serve_args(teacher if which == "teacher" else student))
    assert stats["sampler"] == ("ddim5" if which == "teacher" else "distilled1")
    # the CPU is shared with other tests: count, do not time
    assert stats["ticks_scheduled"] == 50 and stats["replans"] >= 1
    # every tick after the first chunk arrived commands the plant
    assert stats["commands_delivered"] == stats["ticks"] - stats["ticks_without_chunk"] >= 1
    assert stats["nonfinite_chunks"] == 0 and np.isfinite(stats["first_plan_ms"])
    assert np.isfinite(stats["plan_ms"]["p50"]) and np.isfinite(stats["tick_lateness_ms"]["p99"])
    assert cli.main(["serve", str(student), "--device", "cpu", "--duration", "0.5"]) == 0


def test_serve_over_udp(checkpoints):
    _, _, student = checkpoints
    plant = SimulatedRobotIO(20)
    server = UdpRobotServer(plant, "127.0.0.1:0", rate_hz=50.0)
    host, port = server.local_addr
    th = threading.Thread(target=server.serve, args=(None, 4.0), daemon=True)
    th.start()
    try:
        stats = cli.serve(serve_args(student, "--udp", f"{host}:{port}"))
        sent = stats["ticks"] - stats["ticks_without_chunk"]
        deadline = time.monotonic() + 5.0  # the server's receive thread drains the socket
        while server.commands_received < sent and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        server._stop.set()
        th.join(timeout=5.0)
        server.close()
    assert stats["commands_delivered"] is None  # the driver side counts none
    assert stats["replans"] >= 1 and stats["nonfinite_chunks"] == 0
    assert 1 <= server.commands_received == plant.commands_received == sent
    assert np.isfinite(plant.positions).all() and np.abs(plant.positions).max() > 0


def test_serve_raises_what_the_warm_up_raises(checkpoints, monkeypatch):
    """The sampler's warm-up runs on a worker thread; its failure (a kernel
    that does not build, say) reaches the caller before the loop starts."""
    from soccerdiffusion_tpu_torch import inference

    def broken(*args, **kwargs):
        def sample_fn(batch, noise):
            raise ValueError("the sampler failed")
        return sample_fn

    monkeypatch.setattr(inference, "make_chunk_sampler", broken)
    with pytest.raises(ValueError, match="the sampler failed"):
        cli.serve(serve_args(checkpoints[2]))


def test_serve_defaults_to_the_card(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    _, teacher, _ = checkpoints
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", str(teacher), "--duration", "0.1"])


@pytest.mark.parametrize("verb", ["import", "pack", "recording2mcap"])
def test_recording_verbs_need_ingest(verb, tmp_path, caplog):
    """The recording verbs run through the port's ingest/ and exit 0 on the
    committed Bit-Bots bag."""
    bag, db = REPO / "tests" / "fixtures" / "bitbots_synth.mcap", tmp_path / "db.sqlite3"
    if verb != "pack":
        assert cli.main(["import", "bit-bots", str(bag), "field", "--db", str(db)]) == 0
    with caplog.at_level(logging.ERROR, logger="soccerdiffusion_tpu_torch"):
        if verb == "pack":
            assert cli.main(["pack", "bit-bots", str(bag), "field", str(tmp_path / "out")]) == 0
            assert (tmp_path / "out" / "index.json").is_file()
        elif verb == "recording2mcap":
            out = tmp_path / "out.mcap"
            assert cli.main(["db", "recording2mcap", "1", str(out), "--db", str(db)]) == 0
            assert out.read_bytes()[:8] == b"\x89MCAP0\r\n"
        else:
            assert connect(db, read_only=True).execute("SELECT COUNT(*) FROM Image").fetchone()[0]
    assert not caplog.text


def test_recording_verbs_parse_as_in_jax():
    with pytest.raises(SystemExit):
        cli.main(["import", "unknown-team", "rec.mcap", "field"])
