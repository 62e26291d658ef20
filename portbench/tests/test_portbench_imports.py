"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.harness import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def harness_files() -> list[Path]:
    return sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def test_no_source_names_the_jax_stack():
    for path in harness_files():
        assert not imported_tops(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert imported_tops(path) <= {"__future__", "math", "numpy", "torch"}, path


def test_loaded_modules_hold_no_jax():
    """Every module that run.py, the drivers, the metric readers and the
    program's modules they use load, in a fresh process."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
import portbench.run
from portbench import harness
d = Path({str(BENCH_DIR)!r})
for path in sorted((d / "drivers").glob("*.py")):
    harness.load_driver(d, path.stem)
for name in {[m["name"] for m in bench["per_layer"]]!r}:
    harness.load_metric(d, name)
import soccerdiffusion_tpu_torch.inference, soccerdiffusion_tpu_torch.training.trainer
import soccerdiffusion_tpu_torch.models, soccerdiffusion_tpu_torch.data
import soccerdiffusion_tpu_torch.diffusion, soccerdiffusion_tpu_torch.config
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compared_whole(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "soccerdiffusion_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                           if m.split(".")[0] in FORBIDDEN]
    assert "soccerdiffusion_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax", object())
    assert "flax" in harness.forbidden_modules()
