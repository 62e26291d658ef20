"""Run one cell of the benchmark of ``soccerdiffusion_tpu_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's file (``portbench/workloads/<cell>.json``)
names its configuration, its traffic driver and its parameters. A run sets
up the program from the seed (weights, normaliser, inputs), warms every
shape the window uses, measures for ``--seconds``, then frees the program and
holds what the window produced against the plain reference
(``portbench/reference/``). With ``--trace 1`` a bounded stretch after the
window runs under ``torch.profiler`` and the line carries the per-layer
metrics instead of the end-to-end ones.

The last line of standard output is the result as one JSON object; the
numbers compared with the reference, each with its limit, end standard
error and the line (``checks``). Without a card, or with fewer cards than
the cell asks for, the run prints no result and exits with 3.
"""

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import os  # noqa: E402

# one host thread for the CPU ops: the window's host work is a launch path,
# and idle OpenMP workers spinning beside it only add noise to the periods
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the CUDA driver's JIT cache inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))

from portbench import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """nvidia-smi's name, power limit and clocks of the card ("" without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def trace_stretch(drv, units: int, device):
    """``units`` periods or steps under torch.profiler, after two warm ones
    outside it, reduced in memory; the traced window runs from the first
    event to the last."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    drv.traced(2)
    drv.sync()
    with profile(activities=activities) as prof:
        drv.traced(units)
        drv.sync()
    events = prof.events()
    window_s = 0.0
    if events:
        window_s = (max(e.time_range.end for e in events)
                    - min(e.time_range.start for e in events)) * 1e-6
    return harness.reduce_profile(prof, units, window_s)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None, side: str = "program",
             t0: float = T0) -> dict:
    """The result of one run (the contract's JSON object, ``checks`` last).

    ``side`` is what the check judges: the program's output ("program"), a
    control that the cell's driver lists in ``CONTROLS`` (the reference in
    that lower precision, put in the program's place), or a fault that it
    lists in ``FAULTS``, planted under the timed path. The benchmark's own
    runs judge the program; ``calibrate.py`` reads the others."""
    import torch

    bench_dir = root / "portbench"
    bench = harness.manifest(root)
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {cell_name!r}: BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    e2e, per_layer = harness.cell_metrics(bench, cell_name)
    cell = harness.load_cell(bench_dir, cell_name)
    conf = harness.load_config(bench_dir, cell["config"])
    for key, value in (overrides or {}).items():  # tests only: tiny shapes on the CPU
        (conf["model"] if key in conf["model"] else cell)[key] = value
    dev = torch.device(device)
    torch.set_num_threads(1)
    traffic = harness.load_driver(bench_dir, cell["driver"])
    if side != "program" and side not in traffic.CONTROLS + traffic.FAULTS:
        raise SystemExit(f"unknown side {side!r}: the driver has the controls {traffic.CONTROLS} "
                         f"and the faults {traffic.FAULTS}")
    fault = side if side in traffic.FAULTS else None
    drv = traffic.Driver(cell, conf, seed, dev, fault)
    drv.setup()
    drv.sync()
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's generations: steadier periods
    win = drv.window(seconds)
    win["unit_flops"] = drv.unit_flops()
    setup_s = win["t_start"] - t0
    result_trace = None
    if trace:
        result_trace = trace_stretch(drv, cell[f"trace_{drv.unit}s"], dev)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        kind, peak = "cpu", 0
    run = harness.Run(cell=cell, cfg=conf["model"], device_name=kind, window=win, trace=result_trace)
    metrics = {}
    if trace:
        for m in per_layer:
            value = harness.load_metric(bench_dir, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else win["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    control = (side,) if side in traffic.CONTROLS else ()
    readings = drv.check(control)[side if control else "program"]
    limits = cell["limits"]
    # a control reads only the numbers of the stages it takes the program's place in
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits if k in readings}
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": peak}
    result = {"correct": bool(correct and win["failed"] == 0), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": device_info}
    if result_trace is not None:
        device_info["busy_s"] = result_trace.busy_s()
        device_info["window_s"] = result_trace.window_s
        result["breakdown"] = {"device_ops": result_trace.top_device_ops(),
                               "idle_gaps": result_trace.idle_gaps()}
    result["read"] = {k: v for k, v in readings.items() if k not in limits}  # read, not compared
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    bench = harness.manifest(ROOT)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    chips = entry["chips"] if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}: no result", file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX stack are loaded: {found}: no result", file=sys.stderr)
        return 4
    card = card_line()
    print(f"portbench: card {card}; peaks from work.PEAK_FLOPS / PEAK_BYTES (published, "
          f"at the full power limit)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
