"""roofline_share.K1: K1's share of its roofline (portbench/roofline/K1.py)
over the traced slice's K1 launches, in percent."""

from portbench.harness import core
from portbench.harness.layers import roofline_share

CALLS = {"K1": "slam_tpu_torch.ops.icp_fused:icp_fused_planes"}


def read(data):
    return roofline_share(data, core.load_module(core.ROOT, "roofline", "K1"),
                          "K1")
