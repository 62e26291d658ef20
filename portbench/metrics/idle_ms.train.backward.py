"""The card's idle time while the host was in the training step's backward stage
(``sd.train.backward``: the grads reset, ``loss.backward()`` and the zero grads
of unused leaves), in ms a traced step: ``spans.idle_in_spans`` over the traced
steps. None without the span (a program that does not open it) or without a
device timeline."""

from portbench.spans import idle_in_spans

SPANS = ("sd.train.backward",)


def read(run):
    t = run.trace
    if t is None or not t.units or not t.device_ops:
        return None
    idle = idle_in_spans(t, SPANS)
    return None if idle is None else 1e3 * idle / t.units
