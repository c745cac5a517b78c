"""K3 (csrc/icp_tiled.cu): the fit loop streamed over model splits, one
set-up launch and max_iterations match launches a call, on (B, S) scene
and (B, C) model planes of any size.

Bytes and operations are counted as for K1 (portbench/roofline/K1.py):
the class planes whole, x and y at the valid slots, the initial pose
and the result; one squared distance (5 f32 operations) for every
same-class scene x model pair in every fit iteration each robot runs,
the iterations those of the plain reference's fit on the call's own
arguments (its valid points packed, as the reference runs at this
scale)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_roofline_common", Path(__file__).parent / "common.py")
common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(common)

KERNEL = "k3_"
bound_s = common.bound_s


def count(args, kwargs, data):
    """(bytes, operations) of one icp_fused_planes_tiled call."""
    from portbench.reference import slam3d as ref
    sx, sy, sc, mx, my, mc, init, cfg = args[:8]
    icp_cfg = {k: getattr(cfg, k) for k in (
        "max_iterations", "inlier_dist", "min_delta", "min_scene_points")}
    B = sx.shape[0]
    valid = int((sc >= 0).sum()) + int((mc < 2).sum())
    moved = common.nbytes(sc, mc) + 8 * valid + B * 4 * 4 + B * 8 * 4
    pairs = ((sc == 0).sum(-1) * (mc == 0).sum(-1) +
             (sc == 1).sum(-1) * (mc == 1).sum(-1)).double()
    iters = ref.icp_compact(sx, sy, sc >= 0, sc == 1, mx, my, mc < 2,
                            mc == 1, init, icp_cfg, 16)[3].double()
    return moved, 5.0 * float((iters * pairs).sum())
