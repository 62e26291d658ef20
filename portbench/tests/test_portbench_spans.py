"""``spans.idle_in_spans`` and the ``idle_ms.*`` readers on synthetic traces:
a device op that straddles a span's edge counts up to the edge, no span
reads None, and the stages' idle plus the idle outside the program's spans
is the trace's whole idle time, counted here microsecond by microsecond."""

from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.spans import idle_in_spans

ROOT = Path(__file__).resolve().parents[2]
SERVE = ("sd.rollout.encode", "sd.rollout.sample", "sd.rollout.feedback")
TRAIN = ("sd.train.draw", "sd.train.forward", "sd.train.backward", "sd.train.optimizer")


def period_trace() -> harness.Trace:
    """Two periods' worth in 100 us: encode [0, 20), sample [20, 50), a draw
    outside the spans, feedback [60, 90); kernels at 5-25 (across the encode
    / sample edge), 30-35 and a copy at 70-95 (across feedback's end)."""
    t = harness.Trace(units=2, window_s=100e-6)
    t.host_ops = [("sd.rollout.encode", 0.0, 20.0), ("sd.rollout.sample", 20.0, 50.0),
                  ("aten::randn", 50.0, 55.0), ("sd.rollout.feedback", 60.0, 90.0)]
    t.device_ops = [("k1", 5.0, 25.0), ("k2", 30.0, 35.0), ("Memcpy HtoD", 70.0, 95.0)]
    return t


def grid_idle(trace, inside) -> float:
    """Seconds of the window, in 1 us cells, in which no device op ran and
    ``inside(mid)`` holds (integer-microsecond traces only)."""
    mids = np.arange(int(round(trace.window_s * 1e6))) + 0.5
    busy = np.zeros(mids.shape, bool)
    for _, s, e in trace.device_ops:
        busy |= (mids > s) & (mids < e)
    return float(np.sum(~busy & np.array([inside(m) for m in mids]))) * 1e-6


def test_a_straddling_op_counts_up_to_the_edge():
    t = period_trace()
    assert idle_in_spans(t, {"sd.rollout.encode"}) == pytest.approx(5e-6)
    assert idle_in_spans(t, {"sd.rollout.sample"}) == pytest.approx(20e-6)  # 20-25 covered
    assert idle_in_spans(t, {"sd.rollout.feedback"}) == pytest.approx(10e-6)  # 70-90 covered
    assert idle_in_spans(t, set(SERVE)) == pytest.approx(35e-6)


def test_no_span_reads_none():
    t = period_trace()
    assert idle_in_spans(t, {"sd.train.forward"}) is None
    t.host_ops = [("aten::einsum", 0.0, 50.0)]  # the parent's program: ops, no spans
    assert idle_in_spans(t, set(SERVE)) is None
    assert idle_in_spans(t, {"aten::einsum"}) == pytest.approx(25e-6)  # any name


@pytest.mark.parametrize("seed", range(6))
def test_stages_and_the_rest_add_up_to_the_idle(seed):
    """Random traces: non-overlapping top-level spans among other host ops,
    overlapping device ops of any length. Each stage's idle is the grid's
    count inside it, and the stages plus the idle outside every program span
    equal window_s - busy_s()."""
    rng = np.random.default_rng(seed)
    names = SERVE if seed % 2 else TRAIN
    window = 400
    cuts = np.sort(rng.choice(np.arange(1, window), size=2 * len(names) * 2, replace=False))
    t = harness.Trace(units=2, window_s=window * 1e-6)
    spans = []
    for k, (s, e) in enumerate(zip(cuts[::2], cuts[1::2])):
        name = names[k % len(names)]
        t.host_ops.append((name, float(s), float(e)))
        spans.append((float(s), float(e)))
    t.host_ops.append(("aten::to", float(cuts[-1]), float(window)))
    for _ in range(25):
        s = int(rng.integers(0, window - 1))
        t.device_ops.append((f"k{_}", float(s), float(min(window, s + rng.integers(1, 40)))))
    in_span = lambda m, ss: any(a < m < b for a, b in ss)
    stages = 0.0
    for name in names:
        mine = [(s, e) for n, s, e in t.host_ops if n == name]
        got = idle_in_spans(t, {name})
        assert got == pytest.approx(grid_idle(t, lambda m: in_span(m, mine)), abs=1e-12)
        stages += got
    outside = grid_idle(t, lambda m: not in_span(m, spans))
    assert stages + outside == pytest.approx(t.window_s - t.busy_s(), abs=1e-12)


READERS = [f"idle_ms.rollout.{s}" for s in ("encode", "sample", "feedback")] + \
          [f"idle_ms.train.{s}" for s in ("forward", "backward", "optimizer")]


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_ms_a_unit_or_none(name):
    """The reader's span in the sample stage's place: 20 us idle over 2 units."""
    module = harness.load_metric(ROOT / "portbench", name)
    assert module.SPANS == ("sd." + name.split(".", 1)[1],)
    t = period_trace()
    t.host_ops = [(module.SPANS[0] if n == "sd.rollout.sample" else n + ".other", s, e)
                  for n, s, e in t.host_ops]
    run = harness.Run(cell={}, cfg={}, device_name="NVIDIA H100 80GB HBM3", window={}, trace=t)
    assert module.read(run) == pytest.approx(1e3 * 20e-6 / 2)
    assert module.read(harness.Run({}, {}, "cpu", {}, None)) is None
    t.host_ops = [("aten::einsum", 0.0, 50.0)]  # the parent's program
    assert module.read(run) is None
    t.host_ops, t.device_ops = period_trace().host_ops, []  # no device timeline (a CPU run)
    assert module.read(run) is None
