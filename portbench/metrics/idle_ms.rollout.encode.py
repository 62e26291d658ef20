"""The card's idle time while the host was in the rollout engine's encode stage
(``sd.rollout.encode``: the controller's batch and the context encoder, the
null-modality context too under guidance), in ms a traced period:
``spans.idle_in_spans`` over the traced periods. None without the span (a
program that does not open it) or without a device timeline."""

from portbench.spans import idle_in_spans

SPANS = ("sd.rollout.encode",)


def read(run):
    t = run.trace
    if t is None or not t.units or not t.device_ops:
        return None
    idle = idle_in_spans(t, SPANS)
    return None if idle is None else 1e3 * idle / t.units
