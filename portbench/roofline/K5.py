"""K5 (csrc/particle.cu, pf_score_kernel / pf_score_warp_kernel): each
robot's particles scored against the occupancy bit table, one launch a
call.

Bytes: the scored scan points and mask (the strided view's elements
only), the particles, the bit table and the grid's centre read once, one
f32 score a particle written. Operations: 12 f32 operations for every
(particle, valid scored point) pair (the rotation's 4 products and 4
sums, the centre's 2 differences, 2 products by the cell scale).
Written again from the port's chip_smoke.py (pf_bound)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_roofline_common", Path(__file__).parent / "common.py")
common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(common)

KERNEL = "pf_score"
bound_s = common.bound_s


def count(args, kwargs, data):
    """(bytes, operations) of one particle._score_kernel call: (bits,
    grid, scan_xy, valid, particles, resolution)."""
    bits, grid, scan_xy, valid, parts = args[:5]
    B, P, _ = parts.shape
    moved = (scan_xy.numel() * scan_xy.element_size() + valid.numel() +
             common.nbytes(parts, bits, grid.center) + B * P * 4)
    return moved, 12.0 * P * float(valid.sum())
