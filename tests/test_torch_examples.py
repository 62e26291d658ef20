"""The port's example zoo (soccerdiffusion_tpu_torch/examples/) and its
geometry utilities against the JAX package's, on the CPU with torch on one
thread:

  * the two example models (``CausalBinTransformer``, ``MLPDenoiser``) on
    the JAX parameters and seed-made inputs: within 1e-5 in float32;
  * the data each example makes (``gait_bins``, ``sine_batch``,
    ``leg_windows``, ``fetch_data``'s rows): bit for bit;
  * ``utils/geometry.py``: within 1e-6;
  * every example's ``main(["--device", "cpu", ...])``: e2e_smoke,
    realtime_demo (both modes), visualize_dataset, fetch_data and
    preliminary_context_robot (fed by fetch_data's CSV) at the JAX tests'
    arguments, to their PASS line; sine_diffusion_toy, ar_bin_baseline and
    mlp_denoiser_multijoint at a tenth of their steps or fewer (their full
    runs take 20-55 s each on one thread here), to their verdict line;
  * asked for ``--device cuda`` without a card, every example raises.
"""

import importlib
import importlib.util
import math
import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.utils import geometry as jax_geometry
from soccerdiffusion_tpu_torch import utils as port_utils
from soccerdiffusion_tpu_torch.examples import (
    ar_bin_baseline,
    fetch_data,
    mlp_denoiser_multijoint,
    sine_diffusion_toy,
)

REPO = Path(__file__).resolve().parent.parent
BAG = REPO / "tests" / "fixtures" / "bitbots_synth.mcap"
EXAMPLES = ("sine_diffusion_toy", "ar_bin_baseline", "mlp_denoiser_multijoint",
            "preliminary_context_robot", "fetch_data", "e2e_smoke", "realtime_demo",
            "visualize_dataset")
F32_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def leg_db(tmp_path_factory):
    """The MLP example's default database: the dummy-data CLI's 2 x 1500 rows."""
    from soccerdiffusion_tpu_torch.cli import main as cli

    db = str(tmp_path_factory.mktemp("legs") / "mlp_prelim.sqlite3")
    cli(["db", "create-schema", "--db", db])
    cli(["db", "dummy-data", "-n", "2", "-s", "1500", "-i", "50", "--db", db])
    return db


def test_gait_bins_and_sine_batch_bit_for_bit():
    ja, js = jax_example("ar_bin_baseline"), jax_example("sine_diffusion_toy")
    np.testing.assert_array_equal(ar_bin_baseline.gait_bins(np.random.default_rng(5), 9),
                                  ja.gait_bins(np.random.default_rng(5), 9))
    got, want = (sine_diffusion_toy.sine_batch(np.random.default_rng(6), 7),
                 js.sine_batch(np.random.default_rng(6), 7))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_causal_bin_transformer_matches_flax():
    ja = jax_example("ar_bin_baseline")
    jmodel = ja.CausalBinTransformer()
    params = jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, ja.SEQ, ja.JOINTS), jnp.int32))
    tokens = ar_bin_baseline.gait_bins(np.random.default_rng(1), 3)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(tokens)))
    model = ar_bin_baseline.load_jax_params(ar_bin_baseline.CausalBinTransformer(),
                                            jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    # the port's own initial tree has flax's structure and shapes
    drawn = ar_bin_baseline.flax_init(0)
    assert jax.tree.map(np.shape, drawn) == jax.tree.map(np.shape, dict(params["params"]))


def test_mlp_denoiser_matches_flax():
    jm = jax_example("mlp_denoiser_multijoint")
    jmodel = jm.MLPDenoiser()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, jm.WINDOW, 12)).astype(np.float32)
    t = rng.integers(0, 1000, (5,)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.key(4), jnp.zeros((1, jm.WINDOW, 12)),
                                  jnp.zeros((1,), jnp.int32))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    model = mlp_denoiser_multijoint.load_jax_params(mlp_denoiser_multijoint.MLPDenoiser(),
                                                    jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_leg_windows_bit_for_bit(leg_db):
    want = jax_example("mlp_denoiser_multijoint").leg_windows(leg_db)
    got = mlp_denoiser_multijoint.leg_windows(leg_db)
    assert got.shape == want.shape == (930, 70, 12)
    np.testing.assert_array_equal(got, want)


def test_fetch_data_rows_bit_for_bit(tmp_path):
    jf = jax_example("fetch_data")
    topic = "/DynamixelController/command"
    want = jf.fetch(str(BAG), topic, jf.LEG_JOINT_NAMES)
    assert fetch_data.fetch(str(BAG), topic, fetch_data.LEG_JOINT_NAMES) == want
    assert fetch_data.main([str(BAG), "-o", str(tmp_path / "legs.csv"), "--device", "cpu"]) == 0
    lines = (tmp_path / "legs.csv").read_text().splitlines()
    assert len(lines) == len(want) + 1 and lines[0].split(",")[1:] == fetch_data.LEG_JOINT_NAMES


def test_geometry_matches_the_jax_package():
    rng = np.random.default_rng(7)
    quats = np.concatenate([rng.standard_normal((64, 4)) * rng.uniform(0.5, 3.0, (64, 1)),
                            [[0, 0, 0, 1], [0, 0, 0, -2.0], [1e-9, 0, 0, 1], [0, 1, 0, 0]]])
    quats = quats.astype(np.float32).reshape(2, 34, 4)
    q = torch.from_numpy(quats)
    for name in ("quats_to_5d", "xyzw2wxyz", "wxyz2xyzw"):
        got = getattr(port_utils, name)(q).numpy()
        want = np.asarray(getattr(jax_geometry, name)(jnp.asarray(quats)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
    radians = np.concatenate([rng.uniform(-np.pi, np.pi, 200),
                              [-np.pi, 0.0, np.pi, 2 * np.pi - 1e-6]]).astype(np.float32)
    for name in ("shift_radian_to_positive_range", "shift_radian_to_symmetric_range"):
        got = getattr(port_utils, name)(torch.from_numpy(radians)).numpy()
        want = np.asarray(getattr(jax_geometry, name)(jnp.asarray(radians)))
        # the two remainders may land either side of the 2 pi wrap for a
        # value one ulp from it: compare on the circle
        gap = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - want))))
        assert gap.max() <= 1e-6, (name, gap.max())
    assert port_utils.geometry.TWO_PI == pytest.approx(2 * math.pi)


def run_main(capsys, name: str, *argv) -> tuple[int, str]:
    rc = importlib.import_module(f"soccerdiffusion_tpu_torch.examples.{name}").main(
        ["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


def test_e2e_smoke_passes(capsys):
    rc, out = run_main(capsys, "e2e_smoke")
    assert rc == 0 and "E2E SMOKE PASSED" in out, out


@pytest.mark.parametrize("udp", [False, True], ids=["virtual_clock", "udp"])
def test_realtime_demo_passes(capsys, udp):
    rc, out = run_main(capsys, "realtime_demo", *(["--udp"] if udp else []))
    line = "REALTIME UDP DEMO PASSED" if udp else "REALTIME DEMO PASSED"
    assert rc == 0 and line in out, out


def test_visualize_dataset_writes_its_plots(capsys, tmp_path):
    rc, out = run_main(capsys, "visualize_dataset", "--dummy", "-o", str(tmp_path / "viz"))
    assert rc == 0 and f"wrote plots to {tmp_path / 'viz'}/" in out, out
    assert {p.name for p in (tmp_path / "viz").iterdir()} == {"recording_timeseries.png",
                                                            "recording_images.png"}


def test_fetch_data_feeds_preliminary_training(capsys, tmp_path, monkeypatch):
    """The reference's preliminary chain at the JAX test's arguments: the
    fixture bag's 12 leg joints to CSV, the history-only model trained 120
    steps from it and plotted, then ``--run`` samples the saved EMA weights."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the example's checkpoint
    csv_path, png = tmp_path / "legs.csv", tmp_path / "plots" / "prelim.png"
    rc, out = run_main(capsys, "fetch_data", str(BAG), "-o", str(csv_path))
    assert rc == 0 and "wrote 600 rows x 12 joints" in out, out
    rc, out = run_main(capsys, "preliminary_context_robot", "--csv", str(csv_path),
                       "--steps", "120", "--out", str(png))
    assert rc == 0 and "12 joints" in out and f"wrote {png}" in out and png.exists(), out
    trained = float(out.split("open-loop MSE over 4 windows: ")[1].split()[0])
    rc, out = run_main(capsys, "preliminary_context_robot", "--csv", str(csv_path), "--run",
                       "--out", str(png))
    assert rc == 0 and "train:" not in out
    assert float(out.split("open-loop MSE over 4 windows: ")[1].split()[0]) == trained


@pytest.mark.parametrize("name,steps,verdict", [
    ("sine_diffusion_toy", 60, "SINE TOY"),
    ("ar_bin_baseline", 80, "AR BIN BASELINE"),
    ("mlp_denoiser_multijoint", 100, "MLP MULTI-JOINT"),
])
def test_trainers_run_to_their_verdict(capsys, monkeypatch, leg_db, name, steps, verdict):
    """Fewer steps than the gates are set for (the full PASS runs on the
    card): each trains, samples and prints its verdict, and the loss falls."""
    module = importlib.import_module(f"soccerdiffusion_tpu_torch.examples.{name}")
    argv = []
    if name == "mlp_denoiser_multijoint":
        argv = ["--db", leg_db, "--steps", str(steps)]
    else:
        monkeypatch.setattr(module, "TRAIN_STEPS", steps)
    rc, out = run_main(capsys, name, *argv)
    passed = f"{verdict} PASSED" in out
    assert (passed or f"{verdict} FAILED" in out) and rc == (0 if passed else 1), out
    first = float(re.search(r"step 0: \w+ ([-\d.]+)", out).group(1))
    final = float(re.search(r"; final (?:loss |ce )?([-\d.]+)", out).group(1))
    assert np.isfinite(final) and final < first, out


@pytest.mark.parametrize("name", EXAMPLES)
def test_cuda_without_a_card_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(BAG), "-o", str(tmp_path / "x.csv")] if name == "fetch_data" else []
    if name == "visualize_dataset":
        argv = ["--dummy", "-o", str(tmp_path / "viz")]
    module = importlib.import_module(f"soccerdiffusion_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--device", "cuda", *argv])
    assert not any(tmp_path.iterdir())
