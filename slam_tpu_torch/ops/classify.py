"""Ground-adjacency classification of a registration target — counterpart
of slam_tpu/ops/classify.py (`classify_ga_planes`,
`classify_ground_adjacent`).

Points are binned into a grid centred on the robot; a point is
ground-adjacent (GA) when its bin is occupied, interior and has >=
`threshold` empty 8-neighbours. Batched over robots: planes (B, N), centres
(B, 2).
"""

from __future__ import annotations

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.ops.scatter2d import gather_cells_2d, scatter_add_2d_multi
from slam_tpu_torch.ops.stencil import neighbor_sum_2d
from slam_tpu_torch.types import PointCloud


def classify_ga_planes(px, py, valid, center_xy, num_bins: int,
                       resolution: float, threshold: int = 2,
                       with_extent: bool = False):
    """GA plane (B, N) bool of x / y planes; with_extent also returns the
    mask of points inside the grid."""
    n = num_bins
    bx = torch.floor(true_div(px - center_xy[:, 0:1], resolution)).to(torch.int32) \
        + n // 2
    by = torch.floor(true_div(py - center_xy[:, 1:2], resolution)).to(torch.int32) \
        + n // 2
    inb = (bx >= 0) & (by >= 0) & (bx < n) & (by < n) & valid
    (counts,) = scatter_add_2d_multi(bx, by, (None,), inb, (n, n))
    box = neighbor_sum_2d((counts == 0).to(torch.float32))
    ii = torch.arange(n, device=px.device)
    inner = (ii > 0) & (ii < n - 1)
    ga_bin = (box >= threshold) & (inner[:, None] & inner[None, :]) & \
        (counts > 0)
    (g,) = gather_cells_2d((ga_bin.to(torch.float32),), bx, by)
    ga = (g > 0.5) & inb
    return (ga, inb) if with_extent else ga


def classify_ground_adjacent(cloud: PointCloud, center_xy: torch.Tensor,
                             num_bins: int, resolution: float,
                             threshold: int = 2) -> PointCloud:
    """Set or clear FLAG_GA per point; points beyond the grid keep their
    flag."""
    ga, inb = classify_ga_planes(cloud.xyz[..., 0], cloud.xyz[..., 1],
                                 cloud.valid, center_xy, num_bins,
                                 resolution, threshold, with_extent=True)
    new_flags = torch.where(ga, cloud.flags | PointCloud.FLAG_GA,
                            cloud.flags & ~PointCloud.FLAG_GA)
    return cloud.replace(flags=torch.where(inb, new_flags, cloud.flags))
