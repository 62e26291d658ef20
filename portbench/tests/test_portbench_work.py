"""The frozen counts against the port's own FLOP count of a training step,
and the arithmetic of bounds and the trace's busy time."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import harness, work

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["proprio_fused", "vit_flagship"])
def test_train_step_flops_match_the_port(name):
    """``work.train_step_flops`` equals ``utils/profiling.estimate_flops``
    (torch's FLOP counter over the unfused model, forward and backward) at a
    small batch: both count every matrix, attention and convolution
    product and skip the input gradient of products over data."""
    from soccerdiffusion_tpu_torch.config import ModelConfig
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.profiling import estimate_flops

    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["model"]
    mc = ModelConfig(**cfg)
    with torch.device("meta"):
        model = DiffusionPolicy(dataclasses.replace(mc, compute_dtype="float32"))
    assert work.train_step_flops(cfg, 2) == estimate_flops(model, mc, 2)


def test_counts_of_the_kernel_table():
    """The counts that PERF.md's kernel table was measured with: the
    context encoder's bound at h128 B=1024 and the flagship's step."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "proprio_fused.json").read_text())["model"]
    flops, io = work.context_encode_work(cfg, 1024)
    assert 1e3 * work.bound(flops, io, 989e12, 3.35e12) == pytest.approx(0.1551, abs=1e-4)
    flag = json.loads((ROOT / "portbench" / "configs" / "vit_flagship.json").read_text())["model"]
    assert work.train_step_flops(flag, 64) == 1887409537024
    assert work.context_len(cfg) == 301 and work.context_len(flag) == 311


def test_denoise_reads_the_kv_once():
    """The distilled pass's bytes are its inputs read once and its output
    written once: the projected K/V, the noise, the weights, the
    trajectory. A copy of the K/V into a kernel's layout adds nothing."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "proprio_fused.json").read_text())["model"]
    b, s, e = 8192, work.context_len(cfg), cfg["hidden_dim"]
    flops, io = work.denoise_work(cfg, b)
    kv = b * cfg["num_decoder_layers"] * 2 * s * e * work.BF16
    chunk = b * cfg["trajectory_prediction_length"] * cfg["num_joints"] * work.FP32
    assert io == kv + 2 * chunk + work.decoder_params(cfg) * work.BF16
    assert 1e3 * work.bound(flops, io, 989e12, 3.35e12) == pytest.approx(1.5118, abs=1e-4)


def test_bound_and_busy():
    assert work.bound(989e12, 0, 989e12, 3.35e12) == pytest.approx(1.0)
    assert work.bound(0, 3.35e12, 989e12, 3.35e12) == pytest.approx(1.0)
    t = harness.Trace(units=1, window_s=1.0,
                      device_ops=[("a", 0, 10), ("b", 5, 20), ("Memcpy DtoH", 30, 40)])
    assert t.busy_s() == pytest.approx(30e-6)
    assert [k[0] for k in t.kernels] == ["a", "b"]
    assert t.layer_seconds(("^a$",), ()) == pytest.approx(10e-6)
    assert t.layer_seconds(("zzz",), ()) is None
    t.owned = [("tdot", 5e-6, ("aten::mm", "FusedDecoderLayerBackward"))]
    assert t.layer_seconds(("zzz",), ("FusedDecoderLayer",)) == pytest.approx(5e-6)
    assert t.idle_gaps()[0][1] == pytest.approx(10e-6)
