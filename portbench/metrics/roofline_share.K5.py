"""roofline_share.K5: K5's share of its roofline (portbench/roofline/K5.py)
over the traced slice's scoring calls, in percent."""

from portbench.harness import core
from portbench.harness.layers import roofline_share

CALLS = {"K5": "slam_tpu_torch.ops.particle:_score_kernel"}


def read(data):
    return roofline_share(data, core.load_module(core.ROOT, "roofline", "K5"),
                          "K5")
