"""K1 (csrc/icp_fused.cu): the whole class-constrained fit loop of every
robot in one launch, on (B, S) scene and (B, C) model planes.

Bytes: both class planes whole (they say which slots count), x and y at
the valid slots only, the (B, 4) initial pose and the (B, 8) result.
Operations: one squared distance (5 f32 operations) for every same-class
scene x model pair in every fit iteration each robot runs; the
iterations are those the plain reference's fit runs on the same call's
arguments (the kernel returns no count). Written again from the port's
chip_smoke.py (icp_bytes, icp_ops), without the port's fit_iterations."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_roofline_common", Path(__file__).parent / "common.py")
common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(common)

KERNEL = "icp_fused_planes_kernel"
bound_s = common.bound_s


def fit_iterations(sx, sy, sc, mx, my, mc, init, icp_cfg):
    from portbench.reference import slam2d as ref
    return ref.icp_fused(sx, sy, sc >= 0, sc == 1, mx, my, mc < 2, mc == 1,
                         init, icp_cfg)[3]


def count(args, kwargs, data):
    """(bytes, operations) of one icp_fused_planes call."""
    sx, sy, sc, mx, my, mc, init, cfg = args[:8]
    icp_cfg = {k: getattr(cfg, k) for k in (
        "max_iterations", "inlier_dist", "min_delta", "min_scene_points")}
    B = sx.shape[0]
    valid = int((sc >= 0).sum()) + int((mc < 2).sum())
    moved = common.nbytes(sc, mc) + 8 * valid + B * 4 * 4 + B * 8 * 4
    pairs = ((sc == 0).sum(-1) * (mc == 0).sum(-1) +
             (sc == 1).sum(-1) * (mc == 1).sum(-1)).double()
    iters = fit_iterations(sx, sy, sc, mx, my, mc, init, icp_cfg).double()
    return moved, 5.0 * float((iters * pairs).sum())
