"""The distilled pass: the serving denoiser kernel and the pack kernel that lays out its K/V.

The share, in %, of the least time the card could take for the layer's
work in the traced periods or steps (``work.py``, at the cell's shapes)
over the device time of the layer's kernels in the trace. The pack's time
counts; its copy of the K/V is no work of the pass (``work.denoise_work``)."""

from portbench import work
from portbench.harness import roofline

PATTERNS = ('fused_denoise_kernel', 'pack_context_kv_kernel')
OWNERS = ()


def layer_work(cfg, cell):
    return work.denoise_work(cfg, cell["robots"])


def read(run):
    return roofline(run, PATTERNS, OWNERS, layer_work)
