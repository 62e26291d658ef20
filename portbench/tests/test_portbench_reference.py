"""The plain reference against the port's CPU path at tiny sizes, in
float32: the numbers each cell's check compares read at rounding level
(the port's CPU tensors take its kernels' plain versions)."""

from pathlib import Path

import pytest

from portbench import calibrate, harness
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["proprio_fused.fleet_ddim30_b2048", "proprio_fused.fleet_student1_b8192",
         "vit_flagship.fleet_cached_b512", "vit_flagship.train_b256"]
# float32 on both sides: what is left is the order of float32 sums (and the
# DDIM chain's growth of it over 30 steps)
AGREE = {"chunk_gap": 1e-4, "loop_gap": 1e-5, "start_gap": 0.0,
         "loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_in_float32(cell):
    spec = harness.load_cell(ROOT / "portbench", cell)
    ov = {**tiny.overrides(spec, spec["config"]), "compute_dtype": "float32"}
    r = calibrate.reading(cell, 20260101, 0.2, "program", device="cpu", overrides=ov)
    got = {**{k: c["value"] for k, c in r["checks"].items()}, **r["read"]}
    for name, limit in AGREE.items():
        if name in got:
            assert got[name] <= limit, (name, got)
