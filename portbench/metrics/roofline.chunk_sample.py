"""The chunk sampler: the whole-chunk DDIM kernel, the context's K/V projection in it.

The share, in %, of the least time the card could take for the layer's
work in the traced periods or steps (``work.py``, at the cell's shapes)
over the device time of the layer's kernels in the trace."""

from portbench import work
from portbench.harness import roofline

PATTERNS = ('fused_chunk_kernel',)
OWNERS = ()


def layer_work(cfg, cell):
    return work.chunk_sample_work(cfg, cell["robots"], cell["steps"])


def read(run):
    return roofline(run, PATTERNS, OWNERS, layer_work)
