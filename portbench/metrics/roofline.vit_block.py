"""The image encoder in training: every ViT block forward and backward, with the weight-gradient
products its backward launches.

The share, in %, of the least time the card could take for the layer's
work in the traced periods or steps (``work.py``, at the cell's shapes)
over the device time of the layer's kernels in the trace."""

from portbench import work
from portbench.harness import roofline

PATTERNS = ('vit_block_fwd_kernel', 'vit_block_bwd_kernel')
OWNERS = ('FusedVitBlock',)


def layer_work(cfg, cell):
    return tuple(cfg["vit_depth"] * x for x in work.vit_block_work(cfg, cell["batch"] * cfg["image_context_length"]))


def read(run):
    return roofline(run, PATTERNS, OWNERS, layer_work)
