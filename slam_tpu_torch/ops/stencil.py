"""Box-sum stencils — counterpart of slam_tpu/ops/stencil.py
(`neighbor_sum_2d`).

The JAX package multiplies by banded matrices (an MXU trick); here the box
sum is a separable sum of shifted copies of a zero-padded raster. Cells
outside the grid contribute zero, exactly as the band matrices truncate at
the border: for the ground-adjacency rule an off-grid neighbour counts as
not empty. On a grid split by rows (parallel/rows.py) a slab takes `radius`
rows of each neighbouring slab (a halo): zero padding stays only at the
whole grid's outer edges, and a slab boundary sums its neighbour's real
rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_tpu_torch.parallel.rows import halo


def box_sum_2d(x: torch.Tensor, radius: int = 1, rows=None) -> torch.Tensor:
    """Sum over the (2r+1)^2 window including the centre. x: (..., H, W);
    with `rows`, x is a slab (B, h, W) of a grid split by rows."""
    H, W = x.shape[-2:]
    if rows is None:
        p = F.pad(x, (radius, radius, radius, radius))
    else:
        p = F.pad(halo(x, radius, 0.0, rows), (radius, radius, 0, 0))
    rows_sum = sum(p[..., k:k + H, :] for k in range(2 * radius + 1))
    return sum(rows_sum[..., k:k + W] for k in range(2 * radius + 1))


def neighbor_sum_2d(x: torch.Tensor, radius: int = 1,
                    rows=None) -> torch.Tensor:
    """Box sum excluding the centre cell."""
    return box_sum_2d(x, radius, rows) - x
