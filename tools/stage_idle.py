"""The card's idle time in a benchmark cell, split by the stage the host was
in, and what the port's stage spans cost.

    python3 tools/stage_idle.py --workload <cell> --seed <n> [--seconds 5] [--repeats 3]

One run of the cell through ``portbench/run.py:run_cell`` (set-up from the
seed, a window of ``--seconds``, the check), whose traced stretch is taken
``2 x --repeats`` times in turns: with the spans, and with
``utils/profiling.py:span`` replaced by a null context in the engine and the
trainer (same process, same engine, the periods or steps running on). For
each stretch: its wall ms a unit (the profiler's window over the units).
For every stretch with the spans: the idle ms a unit inside each stage span
(``portbench/spans.py``), outside every stage span (each of the device's
idle gaps less its overlap with the spans, not as a difference), the whole idle
(window - busy) with the relative gap of (stages + outside) to it, and each
stage's idle split by the stage's direct child ops (the part of a gap
under a child op goes to its name, the rest to "(between ops)"), the
largest first. Before the cell, the cost of one ``with span(...)`` with no
profile recording and under a CPU profile. Each record is one JSON line on
standard output.
"""

import argparse
import contextlib
import json
import sys
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, run  # noqa: E402
from portbench.spans import idle_in_spans  # noqa: E402

STAGES = {"period": ("sd.rollout.encode", "sd.rollout.sample", "sd.rollout.feedback"),
          "step": ("sd.train.draw", "sd.train.forward", "sd.train.backward",
                   "sd.train.optimizer")}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


@contextlib.contextmanager
def spans(on: bool):
    """The engine's and the trainer's ``span``, or a null context in its place."""
    from soccerdiffusion_tpu_torch.inference import rollout
    from soccerdiffusion_tpu_torch.training import trainer

    real = (rollout.span, trainer.span)
    if not on:
        null = contextlib.nullcontext()
        rollout.span = trainer.span = lambda name: null
    try:
        yield
    finally:
        rollout.span, trainer.span = real


def span_cost(n: int = 200_000) -> dict:
    """Microseconds a ``with span(...)`` with no profile, and under a CPU one."""
    from torch.profiler import ProfilerActivity, profile

    from soccerdiffusion_tpu_torch.utils.profiling import span

    def one():
        with span("sd.cost"):
            pass

    off = timeit.timeit(one, number=n) / n * 1e6
    with profile(activities=[ProfilerActivity.CPU]):
        on = timeit.timeit(one, number=n // 20) / (n // 20) * 1e6
    return {"span_us_off": off, "span_us_profiled": on}


def idle_gaps(trace) -> list:
    """The intervals (us) between the device's busy union, from the
    stretch's first event to its last."""
    ops = trace.host_ops + trace.device_ops
    at, t1 = min(op[1] for op in ops), max(op[2] for op in ops)
    gaps = []
    for _, s, e in sorted(trace.device_ops, key=lambda op: op[1]):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def by_child(prof, trace, names, n: int = 8) -> dict:
    """Each stage's idle ms a unit by the stage's direct child op."""
    gaps = idle_gaps(trace)
    out = {}
    for ev in prof.events():
        if ev.name not in names or ev.cpu_parent is not None:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        sums = out.setdefault(ev.name, {})
        kids = [(k.name, k.time_range.start, k.time_range.end) for k in ev.cpu_children]
        for a, b in gaps:
            a, b = max(a, s), min(b, e)
            if b <= a:
                continue
            under = 0.0
            for name, ks, ke in kids:
                part = min(b, ke) - max(a, ks)
                if part > 0:
                    sums[name] = sums.get(name, 0.0) + part
                    under += part
            sums["(between ops)"] = sums.get("(between ops)", 0.0) + (b - a - under)
    return {stage: [[k, 1e-3 * v / trace.units] for k, v in sorted(
        sums.items(), key=lambda kv: -kv[1])[:n]] for stage, sums in out.items()}


def split(trace, names) -> dict:
    """Idle ms a unit in each stage span (``idle_in_spans``), outside them
    all (each device gap less its overlap with the spans), and in total."""
    ms = lambda us: 1e-3 * us / trace.units
    stages = {n: 1e3 * (idle_in_spans(trace, {n}) or 0.0) / trace.units for n in names}
    spans = [(s, e) for n, s, e in trace.host_ops if n in names]
    outside = sum((b - a) - sum(max(0.0, min(b, e) - max(a, s)) for s, e in spans)
                  for a, b in idle_gaps(trace))
    total = 1e3 * (trace.window_s - trace.busy_s()) / trace.units
    return {"stages_ms": stages, "outside_ms": ms(outside), "idle_ms": total,
            "sum_gap": (sum(stages.values()) + ms(outside) - total) / total if total else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--tiny", action="store_true",
                   help="the CPU tests' tiny shapes on the CPU: a rehearsal, no device timeline")
    args = p.parse_args(argv)
    emit({"workload": args.workload, "card": run.card_line(), **span_cost()})
    plain, reduce = run.trace_stretch, harness.reduce_profile
    first, profs = [], []

    def keep(prof, units, window_s):
        profs.append(prof)
        return reduce(prof, units, window_s)

    harness.reduce_profile = keep

    def stretches(drv, units, device):
        names = STAGES[drv.unit]
        for r in range(args.repeats):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                with spans(on):
                    trace = plain(drv, units, device)
                row = {"workload": args.workload, "spans": on, "repeat": r, "units": units,
                       "wall_ms": 1e3 * trace.window_s / units}
                if on:
                    row.update(split(trace, names))
                    row["by_child_ms"] = by_child(profs[-1], trace, names)
                    first.append(trace)
                emit(row)
        return first[0]

    run.trace_stretch = stretches
    kw = {}
    if args.tiny:
        from portbench.tests import tiny

        spec = harness.load_cell(ROOT / "portbench", args.workload)
        kw = dict(device="cpu", overrides=tiny.overrides(spec, spec["config"]))
    result = run.run_cell(ROOT, args.workload, args.seed, args.seconds, True, **kw)
    emit({"workload": args.workload, "correct": result["correct"], "metrics": {
        k: v["value"] for k, v in result["metrics"].items()}, "device": result["device"],
        "idle_gaps": result["breakdown"]["idle_gaps"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
