"""The device's idle share over the traced steps, in %: the part of the
traced stretch in which no operation ran on the card."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
