"""The port stands without JAX and without the JAX package, and its
dispatch follows the tensor's device."""

import ast
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


# the JAX stack, the JAX package, and the packages that read its checkpoints
# (the port carries its own msgpack decoder, utils/flax_msgpack.py)
FORBIDDEN = ("jax", "flax", "jaxlib", "soccerdiffusion_tpu", "msgpack", "orbax")


def import_statements(path: Path) -> list:
    """Every import statement of ``path``, at its top or inside a function."""
    tree = ast.parse(path.read_text())
    return [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
            and getattr(n, "module", None) != "__future__"]


def imported_roots(node) -> list:
    """The top-level package of each module an import statement names
    (relative imports name the port itself)."""
    if isinstance(node, ast.ImportFrom):
        return [node.module.split(".")[0]] if node.level == 0 else ["soccerdiffusion_tpu_torch"]
    return [alias.name.split(".")[0] for alias in node.names]


def _imports_nothing_of_jax(statements):
    """Run the import ``statements`` in a fresh interpreter; no module of
    jax, flax, msgpack, orbax or the JAX package (its root included) may be
    loaded after."""
    code = "\n".join(["import sys", *statements,
                       "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                       f"{FORBIDDEN!r})",
                       "assert not bad, bad"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_port_imports_without_jax():
    for module in ("distributed", "mesh", "ring_attention", "comm", "tensor_parallel"):
        assert f"soccerdiffusion_tpu_torch.parallel.{module}" in MODULES
    for module in ("flax_msgpack", "torch_port", "import_torch_checkpoint", "jax_params"):
        assert f"soccerdiffusion_tpu_torch.utils.{module}" in MODULES
    for module in ("rows", "resampling", "ros2_schemas", "mcap_io", "converters", "importer",
                   "bitbots", "bhuman", "streaming", "recording2mcap"):
        assert f"soccerdiffusion_tpu_torch.ingest.{module}" in MODULES
    assert "soccerdiffusion_tpu_torch.training.flat_optim" in MODULES
    assert "soccerdiffusion_tpu_torch.evaluation.ledger" in MODULES
    _imports_nothing_of_jax([f"import {m}" for m in MODULES])



def test_each_module_imports_first():
    """Every module of the port imports as the first of the package in a
    process (no import cycle between the ops and the models)."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    for name in [n for n in sys.modules if n.startswith('soccerdiffusion_tpu_torch')]:\n"
            "        del sys.modules[name]\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_jax_import_in_sources():
    """No import statement anywhere in the port's sources, inside function
    bodies too (which importing a module does not run), names jax, flax,
    jaxlib, msgpack, orbax or the JAX package."""
    for src in sorted(PACKAGE.rglob("*.py")):
        for node in import_statements(src):
            assert not set(imported_roots(node)) & set(FORBIDDEN), f"{src}: {ast.unparse(node)}"
    # the walk reaches an import inside a function body (Config.from_yaml's)
    assert "import yaml" in [ast.unparse(n) for n in import_statements(PACKAGE / "config.py")]


def test_chip_smoke_imports_without_jax():
    """Every import statement of chip_smoke.py, at its top or inside a function."""
    nodes = import_statements(REPO / "chip_smoke.py")
    for node in nodes:
        assert not set(imported_roots(node)) & set(FORBIDDEN), ast.unparse(node)
    statements = [ast.unparse(n) for n in nodes]
    assert "from soccerdiffusion_tpu_torch.ops import fused_vit_block" in statements
    _imports_nothing_of_jax(["import chip_smoke", *statements])


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
                               num_inference_steps=2, device="cpu", **kw)
        _, chunks = engine.make_rollout_fn(1)(engine.init(2, torch.Generator().manual_seed(0)))
        assert torch.isfinite(chunks).all()


def test_training_modules_are_covered():
    """The subprocess check above imports every module of the package,
    the training slice's among them."""
    for m in ("soccerdiffusion_tpu_torch.training.train", "soccerdiffusion_tpu_torch.training.trainer",
              "soccerdiffusion_tpu_torch.training.checkpoint", "soccerdiffusion_tpu_torch.training.metrics",
              "soccerdiffusion_tpu_torch.training.distill", "soccerdiffusion_tpu_torch.inference.sampler",
              "soccerdiffusion_tpu_torch.data.dataset", "soccerdiffusion_tpu_torch.data.pipeline",
              "soccerdiffusion_tpu_torch.data.packed",
              "soccerdiffusion_tpu_torch.ops.fused_encoder_stack",
              "soccerdiffusion_tpu_torch.ops.fused_decoder_layer"):
        assert m in MODULES, m


def test_recorded_data_modules_are_covered_and_need_no_cv2():
    """The recorded-data slice's modules are among those imported above, and
    no module of the port imports cv2 (the resizes and colour conversions
    are numpy's), but for ``ingest/bhuman.py:show_video``, the B-Human
    importer's ``--video`` player, which needs a display and imports it
    when it plays."""
    for m in ("soccerdiffusion_tpu_torch.data.schema", "soccerdiffusion_tpu_torch.data.migrations",
              "soccerdiffusion_tpu_torch.data.resize", "soccerdiffusion_tpu_torch.data.dummy",
              "soccerdiffusion_tpu_torch.native", "soccerdiffusion_tpu_torch.native.build"):
        assert m in MODULES, m
    show_video = next(n for n in ast.walk(ast.parse((PACKAGE / "ingest" / "bhuman.py").read_text()))
                      if isinstance(n, ast.FunctionDef) and n.name == "show_video")
    allowed = {n.lineno: ast.unparse(n) for n in ast.walk(show_video) if isinstance(n, ast.Import)}
    assert list(allowed.values()) == ["import cv2"]
    for src in sorted(PACKAGE.rglob("*.py")):
        for node in import_statements(src):
            if src == PACKAGE / "ingest" / "bhuman.py" and node.lineno in allowed:
                continue
            assert "cv2" not in imported_roots(node), f"{src}: {ast.unparse(node)}"
    assert (PACKAGE / "native" / "framepack.cpp").exists()


def test_evaluation_and_cli_modules_are_covered_and_import_no_matplotlib():
    """The evaluation / CLI slice's modules are among those imported above,
    and importing every module of the port loads no matplotlib (the plots
    import it when they draw)."""
    for m in ("soccerdiffusion_tpu_torch.cli", "soccerdiffusion_tpu_torch.evaluation",
              "soccerdiffusion_tpu_torch.evaluation.openloop",
              "soccerdiffusion_tpu_torch.evaluation.divergence",
              "soccerdiffusion_tpu_torch.evaluation.oracle",
              "soccerdiffusion_tpu_torch.evaluation.report",
              "soccerdiffusion_tpu_torch.inference.player",
              "soccerdiffusion_tpu_torch.inference.realtime",
              "soccerdiffusion_tpu_torch.inference.transport",
              "soccerdiffusion_tpu_torch.inference.plot", "soccerdiffusion_tpu_torch.data.plot"):
        assert m in MODULES, m
    code = "\n".join(["import sys", *[f"import {m}" for m in MODULES],
                      "assert 'matplotlib' not in sys.modules"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for src in sorted(PACKAGE.rglob("*.py")):
        top = ast.parse(src.read_text()).body
        for node in top:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                assert "matplotlib" not in imported_roots(node), f"{src}: {ast.unparse(node)}"


def test_cpu_training_step_takes_plain_versions(monkeypatch):
    """A training step with both fused knobs on CPU tensors builds and
    launches no kernel."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from tests.test_torch_jax_params import SMALL, make_batch, port_config, to_torch

    def no_kernel():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(_build, "library", no_kernel)
    cfg = port_config(SMALL, encoder_fused_stack=True, decoder_fused_block=True,
                      compute_dtype="bfloat16")
    model = DiffusionPolicy(cfg)
    opt = make_optimizer(model, 1e-3, 10)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg.num_joints))
    batch = to_torch(make_batch(cfg, 2, np.random.default_rng(0)))
    batch["joint_command"] = torch.zeros(2, cfg.trajectory_prediction_length, cfg.num_joints)
    metrics = step(create_train_state(model, opt), batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"])


def test_cuda_device_raises_without_gpu():
    """The entry points run on the card unless the caller passes the CPU:
    asked for CUDA, explicitly or by default, they raise without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from soccerdiffusion_tpu_torch.inference.controller import init_controller_state
    from tests.test_torch_jax_params import SMALL, build_pair, port_config

    _, _, model, _, _ = build_pair(SMALL, b=2)
    for kw in (dict(device="cuda"), {}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RolloutEngine(model, make_schedule(100), Normalizer.identity(SMALL.num_joints),
                          fused="chunk", fused_encoder=True, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_controller_state(port_config(SMALL), 2, **kw)
    assert init_controller_state(port_config(SMALL), 2, device="cpu").game_state.device.type == "cpu"


def test_kernel_build_dir_is_keyed_by_sources():
    d = _build.build_dir()
    assert d.parent == REPO / "build" / "kernels"
    assert len(d.name) == 16
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "fused_encoder.cu", "fused_denoise.cu", "fused_chunk.cu", "fused_chunk_int8.cu",
        "fused_encoder_stack.cu", "fused_decoder_layer.cu", "weight_grads.cu",
        "fused_vit_block.cu", "fused_vit_block_hd32.cu", "fused_vit_block_hd64.cu",
        "flash_attention.cu"}
