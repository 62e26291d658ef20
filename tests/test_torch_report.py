"""The port's quality report against the JAX package's ``run_report`` on the
CPU, float32: a teacher, a 1-step distilled student, a training-free
solver row, a guidance row and posterior-mean rows (K=2) on the "vision"
dummy task at ``examples/quality_ledger.py --fast --vision``'s size. Both
reports take the same flax-initialised weights in memory (JAX's through
``teacher_loaded`` and a patched ``_load``, the port's as state dicts) and
the same windows; the port takes the JAX package's noise through
``noise_fn``. The JAX report builds its model as ``JitPolicy`` (its
applies jitted; the function is the same). Every number within 1e-4 relative or 1e-6 absolute
(``tests/test_torch_evaluation.py:assert_close``); the markdown equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.evaluation import report as jreport
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.evaluation import report
from soccerdiffusion_tpu_torch.training.checkpoint import save_checkpoint
from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer
from tests.test_torch_evaluation import (
    FAST_VISION,
    T_TRAIN,
    assert_close,
    JitPolicy,
    datasets,
    jax_noise_fn,
    normalizers,
    pair,
)

TEACHER_STEPS = 5


def hyperparams(cfg=FAST_VISION, task="vision") -> dict:
    return {**dataclasses.asdict(cfg), "train_denoising_timesteps": T_TRAIN,
            "distill_teacher_inference_steps": TEACHER_STEPS, "dummy_task": task}


def both_reports(monkeypatch, cfg=FAST_VISION, task="vision", students=(), **kw):
    """(jax result, port result) of the same report: the teacher from flax's
    init at seed 0, each student at seed 1 + its index (1-step distilled)."""
    jds, ds = datasets(cfg, task)
    jnorm, norm = normalizers(cfg.num_joints)
    _, jvars, model = pair(0, cfg)
    hp = hyperparams(cfg, task)
    jax_loaded, port_loaded = {}, {}
    for i, name in enumerate(students):
        _, svars, student = pair(1 + i, cfg)
        shp = {**hp, "distilled_decoder": True}
        jax_loaded[name] = (shp, svars, jnorm, 1, True)
        port_loaded[name] = (shp, student.state_dict(), norm, 1, True)
    monkeypatch.setattr(jreport, "DiffusionPolicy", JitPolicy)
    monkeypatch.setattr(jreport, "_load", lambda path, prefer_ema=True: jax_loaded[path])
    monkeypatch.setattr(report, "_load", lambda path, prefer_ema=True: port_loaded[path])
    want = jreport.run_report("teacher", list(students), jds, teacher_loaded=(
        hp, jvars, jnorm, TEACHER_STEPS, False), **kw)
    got = report.run_report("teacher", list(students), ds, teacher_loaded=(
        hp, model.state_dict(), norm, TEACHER_STEPS, False), noise_fn=jax_noise_fn(cfg),
        device="cpu", **kw)
    return want, got


@pytest.fixture(scope="module")
def full_reports():
    with pytest.MonkeyPatch.context() as mp:
        return both_reports(mp, students=("student1",), windows=8, chunks=2, batch_size=8,
                            seed=0, solver_rows=[("dpmpp@lambda", 3)],
                            guidance_rows=[(2.0, ("image",))], posterior_mean_k=2)


def test_run_report_matches_jax(full_reports):
    want, got = full_reports
    for key in ("oracle_open_loop", "oracle_open_loop_boundary", "guidance",
                "posterior_mean_boundary", "teacher_self_consistency", "image_sensitivity",
                "image_shuffled_open_loop_boundary"):
        assert key in want, key
    assert [c["name"] for c in want["checkpoints"]] == ["teacher", "student1",
                                                        "teacher+dpmpp3_lambda"]
    assert_close(got, want)


def test_markdown_report_matches_jax(full_reports):
    want, got = full_reports
    assert report.markdown_report(want) == jreport.markdown_report(want)
    assert report.markdown_report(got) == jreport.markdown_report(got)
    assert "Bayes-oracle calibration" in report.markdown_report(got)


@pytest.mark.parametrize("task", ["vision", "decorative"])
def test_report_carries_the_oracle_exactly_when_jax_does(monkeypatch, task):
    """The repaired from_dummy keeps the dummy recordings, so the port's
    report has the oracle rows on the vision task and, as JAX's, not
    elsewhere."""
    want, got = both_reports(monkeypatch, task=task, windows=4, chunks=1, batch_size=4)
    assert ("oracle_open_loop" in got) == ("oracle_open_loop" in want) == (task == "vision")
    assert set(got) == set(want)
    assert_close(got, want)


def test_guidance_rows_are_skipped_for_a_distilled_teacher(monkeypatch, caplog):
    _, ds = datasets()
    _, norm = normalizers()
    _, _, model = pair(0)
    result = report.run_report("s", [], ds, 4, 1, 4, teacher_loaded=(
        hyperparams(), model.state_dict(), norm, 1, True), guidance_rows=[(2.0, ("image",))],
        device="cpu")
    assert "guidance" not in result and "guidance rows skipped" in caplog.text
    assert result["checkpoints"][0]["open_loop"]["sampler"] == "distilled1"


def write_checkpoint(path, cfg_dict, seed=0):
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy

    torch.manual_seed(seed)
    model = DiffusionPolicy(Config.from_dict(cfg_dict).model)
    state = create_train_state(model, make_optimizer(model, 1e-3, 10))
    norm = Normalizer(mean=torch.full((cfg_dict["num_joints"],), float(np.pi)),
                      std=torch.full((cfg_dict["num_joints"],), 0.5))
    save_checkpoint(path, state, norm, cfg_dict, 0)


def test_main_writes_json_and_markdown(tmp_path):
    teacher, student = tmp_path / "teacher", tmp_path / "student"
    write_checkpoint(teacher, hyperparams())
    write_checkpoint(student, {**hyperparams(), "distilled_decoder": True}, seed=1)
    out = tmp_path / "reports" / "ledger"
    result = report.main(["--teacher", str(teacher), "--student", str(student), "--dummy-data",
                          "--windows", "8", "--chunks", "1", "--batch-size", "4",
                          "--solver-row", "ddim2", "--out", str(out), "--device", "cpu"])
    written = json.loads(out.with_suffix(".json").read_text())
    assert written == json.loads(json.dumps(result))
    assert out.with_suffix(".md").read_text() == report.markdown_report(written)
    assert [c["name"] for c in written["checkpoints"]] == ["teacher", "student", "teacher+ddim2"]
    assert np.isfinite(written["noise_floor_mse"]) and "oracle_open_loop" in written


@pytest.mark.parametrize("row", ["dpmpp", "euler10", "dpmpp10@linear"])
def test_main_refuses_a_bad_solver_row(tmp_path, row):
    with pytest.raises(SystemExit):
        report.main(["--teacher", str(tmp_path / "missing"), "--solver-row", row])


def test_parse_solver_row():
    assert report.parse_solver_row("dpmpp10@lambda") == ("dpmpp@lambda", 10)
    assert report.parse_solver_row("ddim10") == ("ddim", 10)
