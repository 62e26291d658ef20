"""The benchmark's machinery, shared by every cell: the manifest and the
per-cell, per-configuration and per-metric files found by name, the
weights made from the seed, the reduction of a torch.profiler trace, and
the result line.

Nothing here names a cell, a configuration or a metric: ``BENCHMARK.json``
lists them, ``workloads/<cell>.json`` gives a cell's configuration, driver
and traffic parameters, ``configs/<config>.json`` the model's sizes,
``drivers/<driver>.py`` the generator of that kind of traffic, and
``metrics/<metric>.py`` the reader of one per-layer metric.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "soccerdiffusion_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(root: Path) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports: those
    without a ``workloads`` list, and those whose list names it."""
    pick = lambda ms: [m for m in ms if "workloads" not in m or cell in m["workloads"]]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


def load_cell(bench_dir: Path, cell: str) -> dict:
    spec = load_json(bench_dir / "workloads" / f"{cell}.json")
    spec["name"] = cell
    return spec


def load_config(bench_dir: Path, name: str) -> dict:
    """The configuration's file; its ``model`` holds the values as run."""
    return load_json(bench_dir / "configs" / f"{name}.json")


def load_driver(bench_dir: Path, name: str):
    return load_module(bench_dir / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def load_metric(bench_dir: Path, name: str):
    safe = re.sub(r"[^A-Za-z0-9_]", "_", name)
    return load_module(bench_dir / "metrics" / f"{name}.py", f"portbench_metric_{safe}")


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds derived from the run's seed (any
    non-negative integer, however large)."""
    words = np.random.SeedSequence(int(seed)).generate_state(2 * n, np.uint32)
    return [(int(words[2 * i]) << 31) ^ int(words[2 * i + 1]) for i in range(n)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (linear interpolation between closest ranks)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ----------------------------------------------------------- weights

def make_weights(model, seed: int, device) -> dict:
    """Fill every parameter of ``model`` from one normal draw of a generator
    on ``device`` seeded with ``seed``, and return a copy of them by name
    (what the reference gets). Dense and convolution kernels are scaled by
    1/sqrt(fan-in), LayerNorm gains are 1 + 0.1 z, biases 0.02 z,
    embeddings and the step token z."""
    import torch
    from torch import nn

    kinds = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            kinds[f"{mname}.{pname}" if mname else pname] = (module, pname)
    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    with torch.no_grad():
        for name, p in params:
            z = flat[off: off + p.numel()].view_as(p)
            off += p.numel()
            module, pname = kinds[name]
            if pname == "bias" or name.endswith("_bias"):
                value = 0.02 * z
            elif isinstance(module, nn.LayerNorm):
                value = 1.0 + 0.1 * z
            elif isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                value = z / math.sqrt(p[0].numel())
            elif name.endswith("patch_kernel"):  # (in, out)
                value = z / math.sqrt(p.shape[0])
            else:  # embeddings, the step token
                value = z
            p.copy_(value)
            out[name] = p.detach().clone()
    return out


# ----------------------------------------------------------- the trace

MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    """What a ``torch.profiler`` trace of ``units`` periods or steps gives
    the readers: every device operation with its interval, and for every
    kernel that a CPU op launched, the names of that op and its ancestors."""

    units: int
    window_s: float
    device_ops: list = field(default_factory=list)  # (name, start_us, end_us)
    owned: list = field(default_factory=list)  # (kernel name, seconds, (op, parent, ...))
    host_ops: list = field(default_factory=list)  # (name, start_us, end_us), top-level CPU ops

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops if not op[0].startswith(MEMORY_OPS)]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the device intervals."""
        total, end = 0.0, -math.inf
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total * 1e-6

    def layer_seconds(self, patterns: tuple, owners: tuple) -> float | None:
        """Device seconds of a layer: the kernels whose name matches one of
        ``patterns``, and every other kernel launched under a CPU op whose
        own name or an ancestor's contains one of ``owners`` (the layer's
        autograd Function and its backward). None where nothing matches."""
        named = [re.compile(p) for p in patterns]
        match = lambda name: any(p.search(name) for p in named)
        seconds, found = 0.0, False
        for name, s, e in self.kernels:
            if match(name):
                seconds += (e - s) * 1e-6
                found = True
        for name, sec, chain in self.owned:
            if not match(name) and not name.startswith(MEMORY_OPS) and any(
                    o in op for op in chain for o in owners):
                seconds += sec
                found = True
        return seconds if found else None

    def top_device_ops(self, n: int = 10) -> list:
        sums: dict[str, float] = {}
        for name, s, e in self.device_ops:
            sums[name] = sums.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle gaps summed by what the host was doing: the
        outermost CPU op running at each gap's midpoint ("host idle" where
        none was)."""
        ops = sorted(self.device_ops, key=lambda op: op[1])
        gaps, end = [], None
        for _, s, e in ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host_ops, key=lambda op: op[1])
        starts = [h[1] for h in host]
        sums: dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = "host idle"
            i = bisect.bisect_right(starts, mid)
            # the outermost op containing mid: scan back over ops that started before it
            best = None  # top-level ops of one thread do not nest: look at the last few
            for j in range(i - 1, max(-1, i - 8), -1):
                h = host[j]
                if h[2] >= mid and (best is None or h[1] <= best[1]):
                    best = h
            if best is not None:
                name = best[0]
            sums[name] = sums.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def reduce_profile(prof, units: int, window_s: float) -> Trace:
    """The trace of a finished ``torch.profiler.profile``, reduced in memory."""
    from torch.autograd import DeviceType

    trace = Trace(units=units, window_s=window_s)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            trace.device_ops.append((e.name, e.time_range.start, e.time_range.end))
            continue
        if e.device_type != DeviceType.CPU:
            continue
        if e.cpu_parent is None:
            trace.host_ops.append((e.name, e.time_range.start, e.time_range.end))
        if e.kernels:
            chain, p = [e.name], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            for k in e.kernels:
                trace.owned.append((k.name, k.duration * 1e-6, tuple(chain)))
    return trace


def roofline(run, patterns: tuple, owners: tuple, work) -> float | None:
    """A layer's share of its roofline over the traced stretch, in %: the
    least time its work could take on the card (``work(cfg, cell)`` gives
    the (FLOPs, bytes) of one period or step) over its device time."""
    from portbench.work import bound, peaks

    trace, pk = run.trace, peaks(run.device_name)
    if trace is None or pk is None:
        return None
    seconds = trace.layer_seconds(patterns, owners)
    if not seconds:
        return None
    flops, io = work(run.cfg, run.cell)
    return 100.0 * trace.units * bound(flops, io, *pk) / seconds


@dataclass
class Run:
    """What a metric reader gets: the cell, its model configuration, the
    card's name, the window's figures and the trace (None without one)."""

    cell: dict
    cfg: dict
    device_name: str
    window: dict
    trace: Trace | None = None
