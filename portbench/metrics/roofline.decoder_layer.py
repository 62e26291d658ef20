"""The decoder layers in training, forward and backward, with the weight-gradient sums
their backward launches.

The share, in %, of the least time the card could take for the layer's
work in the traced periods or steps (``work.py``, at the cell's shapes)
over the device time of the layer's kernels in the trace."""

from portbench import work
from portbench.harness import roofline

PATTERNS = ('decoder_layer_fwd_kernel', 'decoder_layer_bwd_kernel')
OWNERS = ('FusedDecoderLayer',)


def layer_work(cfg, cell):
    return work.decoder_layer_work(cfg, cell["batch"])


def read(run):
    return roofline(run, PATTERNS, OWNERS, layer_work)
