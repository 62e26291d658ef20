"""CUDA kernel launches in the trace, per traced step."""


def read(run):
    t = run.trace
    if t is None or not t.units or not t.device_ops:
        return None
    return len(t.kernels) / t.units
