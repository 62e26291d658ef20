"""The card's idle time inside the program's own stage spans.

The port opens a span at each stage of its replan period and training step
(``soccerdiffusion_tpu_torch/utils/profiling.py:span``, names ``sd.*``):
a CPU op on the calling thread, on the profiler's clock, whose children are
the ops the stage issues. A metric that reads a span needs it top-level,
with no program span or op around it: ``harness.reduce_profile`` keeps only
top-level CPU ops as ``Trace.host_ops``, so a nested span is not seen, and
two nested spans would count the same idle twice. The program's spans keep
to that: no stage span encloses another.
"""

from __future__ import annotations


def _union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_in_spans(trace, names) -> float | None:
    """Seconds in which no operation ran on the card while the host was
    inside a top-level span named in ``names``: for each such span of
    ``trace.host_ops``, its interval less the part the union of
    ``trace.device_ops`` covers (an op that straddles the span's edge
    counts up to the edge), summed. None where the trace holds no such
    span (a program without the spans)."""
    spans = [(s, e) for name, s, e in trace.host_ops if name in names]
    if not spans:
        return None
    busy = _union((s, e) for _, s, e in trace.device_ops)
    idle = 0.0
    for s, e in spans:
        covered = 0.0
        for a, b in busy:
            if a >= e:
                break
            if b > s:
                covered += min(b, e) - max(a, s)
        idle += (e - s) - covered
    return idle * 1e-6
