"""roofline_share.K3: K3's share of its roofline (portbench/roofline/K3.py)
over the traced slice's K3 calls, in percent."""

from portbench.harness import core
from portbench.harness.layers import roofline_share

CALLS = {"K3": "slam_tpu_torch.ops.icp_fused:icp_fused_planes_tiled"}


def read(data):
    return roofline_share(data, core.load_module(core.ROOT, "roofline", "K3"),
                          "K3")
