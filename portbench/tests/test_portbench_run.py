"""Whole runs of the harness on the CPU at tiny sizes (``run.run_cell``
past the look for a card): a sound run is correct, the control in the
program's place fails a number, every fault a cell can have planted
under the timed path turns ``correct`` false, and a cell added as a data
file is found and run. The card's own run is the ``cuda`` test."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import calibrate, harness, run
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# the faults each kind of cell can have: a state returned unchanged, half the
# batch left out, an answer altered where it is produced (no cell spans chips)
FAULTS = ("unchanged", "half_batch", "altered")


def tiny_overrides(cell: str) -> dict:
    spec = harness.load_cell(ROOT / "portbench", cell)
    return tiny.overrides(spec, spec["config"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run.run_cell(ROOT, cell, 2 ** 31 + 12345, 0.2, True, device="cpu",
                          overrides=tiny_overrides(cell))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell):
    """The reference in float8 in the program's place, judged by the run's
    own comparison (``calibrate.py``'s path), reads over one of the cell's
    limits: ``correct`` comes out false."""
    r = calibrate.reading(cell, 7, 0.2, "fp8", device="cpu", overrides=tiny_overrides(cell))
    assert r["checks"] and not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS])
def test_fault_turns_correct_false(cell, fault):
    spec = harness.load_cell(ROOT / "portbench", cell)
    assert fault in harness.load_driver(ROOT / "portbench", spec["driver"]).FAULTS
    result = run.run_cell(ROOT, cell, 99, 0.2, False, device="cpu",
                          overrides=tiny_overrides(cell), side=fault)
    assert not result["correct"], result["checks"]


def test_a_cell_added_as_data_is_run(tmp_path):
    """A copy of the benchmark with one more cell, added as a workload file
    and a BENCHMARK.json entry only, runs that cell."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = json.loads((ROOT / "portbench" / "workloads"
                       / "proprio_fused.fleet_ddim30_b2048.json").read_text())
    spec.update(traffic="fleet_ddim10_b4", robots=4, steps=10, why="a cell made of data")
    (tmp_path / "portbench" / "workloads" / "proprio_fused.fleet_ddim10_b4.json").write_text(
        json.dumps(spec))
    bench["workloads"].append({"name": "proprio_fused.fleet_ddim10_b4", "config": "proprio_fused",
                               "traffic": "fleet_ddim10_b4", "chips": 1, "why": spec["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "proprio_fused.fleet_ddim30_b2048" in m.get("workloads", []):
            m["workloads"].append("proprio_fused.fleet_ddim10_b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import sys, json
sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(1, {str(ROOT)!r})
from pathlib import Path
import portbench.run as r
assert Path(r.__file__).resolve().is_relative_to(Path({str(tmp_path)!r}))
ov = dict({tiny.PROPRIO!r}, reference_rows=2, check_periods=2, warmup_periods=5)
print(json.dumps(r.run_cell(Path({str(tmp_path)!r}), "proprio_fused.fleet_ddim10_b4", 5, 0.2,
                            False, device="cpu", overrides=ov)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"chunks_per_s", "period_ms_p95", "setup_s"}


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero (the
    decision is made when the test runs)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """One short run of each cell on the card, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "3141592653", "--seconds", "2", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
