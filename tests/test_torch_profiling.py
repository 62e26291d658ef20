"""The port's profiling module (utils/profiling.py) on the CPU: the MFU
meter against the JAX package's on one fake clock, the step's FLOP count
against an analytic count of its products and against XLA's cost analysis
of the JAX step, its independence of the fused knobs and its linearity in
the batch, the card's peaks, the trace file, and the stage spans: free
without a profile, top-level CPU ops under one, the training step's four in
order."""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.data import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.training import create_train_state, make_optimizer, make_train_step
from soccerdiffusion_tpu.utils import profiling as jax_profiling
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.utils import profiling
from soccerdiffusion_tpu_torch.utils.profiling import (
    CPU_PEAK_FLOPS,
    MFUMeter,
    device_peak_flops,
    estimate_flops,
    step_flops,
    trace,
)

from tests.test_torch_jax_params import SMALL, make_batch, port_config, to_jax

FUSED = dataclasses.replace(SMALL, encoder_fused_stack=True, decoder_fused_block=True)
B = 4
# torch.utils.flop_counter on the port's unfused SMALL step at B=4, float32
SMALL_FORWARD, SMALL_BACKWARD = 15_691_776, 31_269_888
# XLA's cost analysis over FlopCounterMode's count: XLA also counts the
# elementwise work and the optimizer update, which the products' count
# leaves out (0.94 on SMALL)
XLA_RATIO_BAND = (0.85, 1.0)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(time, "perf_counter", fake)
    return fake


def test_meter_matches_the_jax_meter_on_one_clock(clock):
    """The same start / stop / cancel sequence on both meters, at an equal
    peak and device count, gives equal mfu and steps_per_sec after every
    call."""
    jax_meter = jax_profiling.MFUMeter(flops_per_step=3e9, num_devices=2, peak_flops=5e11)
    meter = MFUMeter(flops_per_step=3e9, num_devices=2, peak_flops=5e11)
    script = [("start", None, 0.0), ("stop", 4, 0.25), ("start", None, 0.5),
              ("cancel", None, 1.0), ("start", None, 0.1), ("stop", 3, 0.125),
              ("start", None, 0.0), ("stop", 1, 0.5)]
    for op, steps, dt in script:
        clock.t += dt
        for m in (jax_meter, meter):
            getattr(m, op)(*(() if steps is None else (steps,)))
        assert meter.mfu == pytest.approx(jax_meter.mfu, rel=1e-12)
        assert meter.steps_per_sec == pytest.approx(jax_meter.steps_per_sec, rel=1e-12)
    assert meter.steps_per_sec == pytest.approx(8 / 0.875)
    assert meter.mfu == pytest.approx(3e9 * 8 / 0.875 / (5e11 * 2))


def test_meter_before_any_window_and_without_a_peak(clock):
    assert MFUMeter(1e9, peak_flops=1e12).mfu == 0.0 == MFUMeter(1e9, peak_flops=1e12).steps_per_sec
    meter = MFUMeter(1e9, peak_flops=None)
    meter.start()
    clock.t += 1.0
    meter.stop(2)
    assert meter.mfu is None and meter.steps_per_sec == 2.0
    with pytest.raises(RuntimeError, match="start"):
        meter.stop()


def test_device_peak_flops_positive():
    """(tests/test_profiling.py's case) The CPU's nominal peak, the JAX package's figure."""
    assert device_peak_flops("cpu") == CPU_PEAK_FLOPS == jax_profiling.PEAK_FLOPS["cpu"] > 0


def test_mfu_meter_accounts_steps():
    """(tests/test_profiling.py's case) 4e5 FLOP over >= 10 ms against any
    real peak is well under 1."""
    meter = MFUMeter(flops_per_step=1e5)
    meter.start()
    time.sleep(0.01)
    meter.stop(steps=4)
    assert meter.steps_per_sec > 0
    assert 0 <= meter.mfu < 1.0


def test_card_peaks_follow_the_dtype(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert device_peak_flops("cuda", "bfloat16") == device_peak_flops("cuda", torch.float16) == 989e12
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert device_peak_flops("cuda", "float32") == 495e12
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert device_peak_flops("cuda", torch.float32) == 67e12


def test_unknown_card_has_no_peak(monkeypatch, caplog):
    """No CPU figure for a card missing from the table: None, and the log
    names the card."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Imaginary GPU 9000")
    with caplog.at_level("WARNING", logger="soccerdiffusion_tpu_torch"):
        assert device_peak_flops("cuda", torch.bfloat16) is None
    assert "Imaginary GPU 9000" in caplog.text
    assert MFUMeter(1e9, peak_flops=device_peak_flops("cuda")).mfu is None


def encoder_flops(t, d, e, layers):
    """A patch-1 sequence encoder over t tokens of d inputs: the embedding,
    then per layer the q / k / v / out projections, the scores and value
    sums over all heads, and the e-wide MLP."""
    return 2 * t * d * e + layers * (12 * t * e * e + 4 * t * t * e)


def decoder_flops(p, s, j, e, layers):
    """The denoiser over p chunk tokens and s memory tokens: the embedding
    and output projections, per layer self-attention, cross-attention
    (queries from the chunk, keys and values from the memory) and the MLP."""
    return 4 * p * j * e + layers * (16 * p * e * e + 4 * s * e * e + 4 * p * p * e
                                     + 4 * p * s * e)


def test_forward_count_equals_the_products_of_the_step():
    cfg = SMALL
    e, j, p = cfg.hidden_dim, cfg.num_joints, cfg.trajectory_prediction_length
    s = cfg.action_context_length + cfg.imu_context_length + cfg.joint_state_context_length + 2
    analytic = B * (encoder_flops(cfg.action_context_length, j, e, 1)
                    + encoder_flops(cfg.imu_context_length, cfg.imu_input_dim, e, 1)
                    + encoder_flops(cfg.joint_state_context_length, j, e, 1)
                    + decoder_flops(p, s, j, e, cfg.num_decoder_layers))
    forward, backward = step_flops(DiffusionPolicy, port_config(SMALL), B)
    assert forward == analytic == SMALL_FORWARD
    assert backward == SMALL_BACKWARD


def test_count_is_the_same_whatever_implements_the_step():
    """The fused layers' backward recomputes their forward, so a count of the
    step as it runs reads high (46,832,640 backward); estimate_flops counts
    the unfused layers whatever the config's knobs."""
    assert step_flops(DiffusionPolicy, port_config(FUSED), B) == (SMALL_FORWARD, 46_832_640)
    fused, small = port_config(FUSED), port_config(SMALL)
    want = SMALL_FORWARD + SMALL_BACKWARD
    assert estimate_flops(DiffusionPolicy(fused), fused, B) == want
    assert estimate_flops(DiffusionPolicy(small), small, B) == want
    remat = port_config(SMALL, remat_decoder=True, attention_impl="pallas")
    assert estimate_flops(DiffusionPolicy(remat), remat, B) == want


TINY_VIT = dict(hidden_dim=64, image_resolution=32, vit_patch_size=8, vit_width=64, vit_depth=2,
                image_encoder_type="vit", image_context_length=3, vit_fused_block=True)
TINY_RESNET = dict(hidden_dim=64, image_resolution=32, image_encoder_type="resnet18",
                   image_context_length=2)


@pytest.mark.parametrize("images", [None, TINY_VIT, TINY_RESNET], ids=["proprio", "vit", "resnet"])
def test_count_is_linear_in_the_batch(images):
    """Every counted product is per robot, so estimate_flops counts one robot
    and scales: the count at B=2 is twice the count at B=1 (the ViT's
    patch embedding and the ResNet's convolutions included)."""
    cfg = port_config(SMALL) if images is None else port_config(SMALL, use_images=True, **images)
    cfg = dataclasses.replace(cfg, **profiling.UNFUSED)
    one, two = step_flops(DiffusionPolicy, cfg, 1), step_flops(DiffusionPolicy, cfg, 2)
    assert two == (2 * one[0], 2 * one[1]) and one[0] > 0
    assert estimate_flops(DiffusionPolicy(cfg), cfg, 3) == 3 * sum(one)


def test_count_against_xla_cost_analysis_of_the_jax_step():
    """XLA's cost analysis of the JAX package's jitted train step on SMALL at
    B=4 counts more (elementwise work and the AdamW update); the products
    are most of it."""
    rng = np.random.default_rng(0)
    batch = make_batch(SMALL, B, rng)
    batch["joint_command"] = rng.uniform(0, 2 * np.pi, (B, SMALL.trajectory_prediction_length,
                                                        SMALL.num_joints)).astype(np.float32)
    model, opt = JaxPolicy(SMALL), make_optimizer(1e-3, total_steps=10)
    state = create_train_state(model, to_jax(batch), opt, jax.random.key(0),
                               SMALL.trajectory_prediction_length, SMALL.num_joints)
    step = make_train_step(model, jax_make_schedule(100), opt,
                           JaxNormalizer(mean=jnp.zeros(SMALL.num_joints),
                                         std=jnp.ones(SMALL.num_joints)), donate=False)
    xla = jax_profiling.estimate_flops(step, state, to_jax(batch), 0)
    ours = estimate_flops(DiffusionPolicy(port_config(SMALL)), port_config(SMALL), B)
    assert XLA_RATIO_BAND[0] <= ours / xla <= XLA_RATIO_BAND[1], (ours, xla)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones((64, 64))
    with trace(tmp_path / "run") as prof:
        (a @ a).sum()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    events = json.loads((tmp_path / "run" / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


# ------------------------------------------------------------ stage spans

ROLLOUT_STAGES = ("sd.rollout.encode", "sd.rollout.sample", "sd.rollout.feedback")
TRAIN_STAGES = ("sd.train.draw", "sd.train.forward", "sd.train.backward", "sd.train.optimizer")


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` profile; returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def assert_stages(prof, names, repeats=1):
    """The profile's ``sd.*`` spans are ``names`` (``repeats`` times over), each
    top-level, none a user annotation, one after another without overlap."""
    spans = sorted((e for e in prof.events() if e.name.startswith("sd.")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == list(names) * repeats
    assert all(e.cpu_parent is None and not e.is_user_annotation for e in spans)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(spans, spans[1:]))
    return spans


def test_span_records_only_under_a_profile(monkeypatch):
    """Without a profile, span() opens no record of any kind (every record
    constructor patched to raise) and hands out one shared null context;
    under a profile it is a top-level CPU op around the ops it issues."""
    def refuse(*args, **kwargs):
        raise AssertionError("a record opened with no profile recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("sd.a"):
        with profiling.span("sd.b"):
            pass
    assert profiling.span("sd.a") is profiling.span("sd.b")
    monkeypatch.undo()
    a = torch.ones((16, 16))

    def stages():
        with profiling.span("sd.a"):
            pass
        with profiling.span("sd.b"):
            a @ a

    (_, outer) = assert_stages(profiled(stages), ("sd.a", "sd.b"))
    assert "aten::matmul" in {c.name for c in outer.cpu_children}


@pytest.mark.parametrize("cfg", [SMALL, FUSED], ids=["plain", "fused"])
def test_train_step_opens_its_stage_spans(cfg):
    """A profiled TrainStep (two steps) holds draw, forward, backward and
    optimizer as top-level spans in that order; the loss is computed inside
    the forward span."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.training.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    model = DiffusionPolicy(port_config(cfg))
    state = create_train_state(model, make_optimizer(model, 1e-3, 10))
    step = make_train_step(model, make_schedule(100), state.optimizer,
                           Normalizer.identity(cfg.num_joints))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, rng).items()}
    batch["joint_command"] = torch.from_numpy(rng.uniform(
        0, 2 * np.pi, (B, cfg.trajectory_prediction_length, cfg.num_joints)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    prof = profiled(lambda: [step(state, batch, gen) for _ in range(2)])
    spans = assert_stages(prof, TRAIN_STAGES, repeats=2)
    assert state.step == 2
    forward = spans[1]
    assert any(c.name == "aten::mean" for c in forward.cpu_children)


def test_no_stage_span_names_a_roofline_owner():
    """portbench's rooflines take a kernel by the name of a CPU op above it
    (its OWNERS); a stage span above every op must contain none of them."""
    import ast
    from pathlib import Path

    owners = set()
    for path in (Path(__file__).resolve().parents[1] / "portbench" / "metrics").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "OWNERS" for t in node.targets):
                owners |= set(ast.literal_eval(node.value))
    assert {"FusedVitBlock", "FusedEncoderStack", "FusedDecoderLayer"} <= owners
    for name in ROLLOUT_STAGES + TRAIN_STAGES:
        assert name == name.lower() and name.startswith("sd.")
        assert not any(o in name for o in owners), name
