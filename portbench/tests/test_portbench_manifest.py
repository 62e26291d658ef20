"""The manifest and every file it names load, and keep to the benchmark's
rules on names, units and keys."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    widths = re.compile(r"(_dim|_rank|hidden|width|intermediate|head)")
    assert not [k for k in entry["reduced"] if widths.search(k)]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    spec = harness.load_cell(ROOT / "portbench", cell)
    assert spec["config"] == entry["config"] and spec["traffic"] == entry["traffic"]
    assert (ROOT / "portbench" / "drivers" / f"{spec['driver']}.py").exists()
    assert spec["limits"]
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if "bound" in metric else {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    assert all(c in CELLS for c in metric.get("workloads", CELLS))
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric["workloads"]:  # every cell that reports it reports what it moves
            assert "workloads" not in moved or cell in moved["workloads"]
        module = harness.load_metric(ROOT / "portbench", metric["name"])
        assert callable(module.read)


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
