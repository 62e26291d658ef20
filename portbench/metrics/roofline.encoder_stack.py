"""The context encoder stacks in training, forward and backward, with the weight-gradient
products their backward launches.

The share, in %, of the least time the card could take for the layer's
work in the traced periods or steps (``work.py``, at the cell's shapes)
over the device time of the layer's kernels in the trace."""

from portbench import work
from portbench.harness import roofline

PATTERNS = ('encoder_stack_fwd_kernel', 'encoder_stack_bwd_kernel')
OWNERS = ('FusedEncoderStack',)


def layer_work(cfg, cell):
    return work.encoder_stack_work(cfg, cell["batch"])


def read(run):
    return roofline(run, PATTERNS, OWNERS, layer_work)
