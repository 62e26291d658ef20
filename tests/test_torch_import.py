"""The port stands without JAX, and its dispatch follows the tensor's device."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "soccerdiffusion_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py"))


def test_port_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
            "assert not bad, bad\n"
            "jax_pkg = sorted(m for m in sys.modules if m.startswith('soccerdiffusion_tpu.'))\n"
            "assert jax_pkg == ['soccerdiffusion_tpu.config'], jax_pkg\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_jax_import_in_sources():
    for src in PACKAGE.rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "flax")), f"{src}: {line}"


def test_cpu_tensors_take_plain_versions(monkeypatch):
    """On CPU tensors no wrapper builds or launches a kernel."""
    from tests.test_torch_jax_params import SMALL, build_pair

    def no_kernel():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(_build, "library", no_kernel)
    _, _, model, _, _ = build_pair(SMALL, b=2)
    for kw in (dict(fused="chunk", fused_encoder=True), dict(fused="step"),
               dict(distilled=True, fused=True)):
        engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(SMALL.num_joints),
                               num_inference_steps=2, **kw)
        _, chunks = engine.make_rollout_fn(1)(engine.init(2, torch.Generator().manual_seed(0)))
        assert torch.isfinite(chunks).all()


def test_training_modules_are_covered():
    """The subprocess check above imports every module of the package,
    the training slice's among them."""
    for m in ("soccerdiffusion_tpu_torch.training.train", "soccerdiffusion_tpu_torch.training.trainer",
              "soccerdiffusion_tpu_torch.training.checkpoint", "soccerdiffusion_tpu_torch.training.metrics",
              "soccerdiffusion_tpu_torch.data.dataset", "soccerdiffusion_tpu_torch.data.pipeline",
              "soccerdiffusion_tpu_torch.ops.fused_encoder_stack",
              "soccerdiffusion_tpu_torch.ops.fused_decoder_layer"):
        assert m in MODULES, m


def test_cpu_training_step_takes_plain_versions(monkeypatch):
    """A training step with both fused knobs on CPU tensors builds and
    launches no kernel."""
    import dataclasses

    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from tests.test_torch_jax_params import SMALL, make_batch, to_torch

    def no_kernel():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(_build, "library", no_kernel)
    cfg = dataclasses.replace(SMALL, encoder_fused_stack=True, decoder_fused_block=True,
                              compute_dtype="bfloat16")
    model = DiffusionPolicy(cfg)
    opt = make_optimizer(model, 1e-3, 10)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg.num_joints))
    batch = to_torch(make_batch(cfg, 2, np.random.default_rng(0)))
    batch["joint_command"] = torch.zeros(2, cfg.trajectory_prediction_length, cfg.num_joints)
    metrics = step(create_train_state(model, opt), batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"])


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from tests.test_torch_jax_params import SMALL, build_pair

    _, _, model, _, _ = build_pair(SMALL, b=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutEngine(model, make_schedule(100), Normalizer.identity(SMALL.num_joints),
                      fused="chunk", fused_encoder=True, device="cuda")


def test_kernel_build_dir_is_keyed_by_sources():
    d = _build.build_dir()
    assert d.parent == REPO / "build" / "kernels"
    assert len(d.name) == 16
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "fused_encoder.cu", "fused_denoise.cu", "fused_chunk.cu", "fused_encoder_stack.cu",
        "fused_decoder_layer.cu", "weight_grads.cu"}
