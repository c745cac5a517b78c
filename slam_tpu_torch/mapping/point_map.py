"""Rolling point-map grid, the scan-to-map target store — counterpart of
slam_tpu/mapping/point_map.py.

Per-cell accumulators (count and cell-relative x / y offset sums, absolute
z sum) on a world-aligned rolling grid per robot. Export turns the most
observed occupied cells into centroid points with ground-adjacency flags.

On a grid split by rows (`rows`, parallel/rows.py) each rank holds a slab
of every robot's rows: the shift rolls through a ring over the sp group,
the update scatters the points of the slab's rows, and the export takes
each slab's top `capacity` cells (with a one-row halo for the GA stencil)
and merges the candidates over the group, which gives the whole grid's
export exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_tpu_torch import default_device, true_div
from slam_tpu_torch.ops.roll import fresh_mask, roll_cells, shift_step
from slam_tpu_torch.ops.scatter2d import gather_cells_2d, scatter_add_2d_multi
from slam_tpu_torch.ops.stencil import neighbor_sum_2d
from slam_tpu_torch.parallel.rows import merge_top, row_index, whole_rows
from slam_tpu_torch.types import PointCloud, Replaceable


@dataclasses.dataclass
class PointMapGrid(Replaceable):
    """sum_x / sum_y hold offsets from each point's cell centre (bounded by
    +-resolution / 2, unchanged by rolling shifts); sum_z is absolute.
    `rows` (static) is the split of the rows over an sp group, the
    channels then (B, G / sp, G); None when whole."""

    count: torch.Tensor   # (B, G, G)
    sum_x: torch.Tensor   # (B, G, G)
    sum_y: torch.Tensor
    sum_z: torch.Tensor
    center: torch.Tensor  # (B, 2) world xy of the grid centre
    resolution: float = 0.5
    rows: object = None


def init_point_map(batch: int, grid_size: int, resolution: float = 0.5,
                   device=None, dtype=torch.float32) -> PointMapGrid:
    """Empty grids; on the card unless `device` says otherwise. Batch 1 is
    config 5's one map shared by the fleet."""
    device = default_device(device)

    def z():
        return torch.zeros(batch, grid_size, grid_size, dtype=dtype,
                           device=device)
    return PointMapGrid(count=z(), sum_x=z(), sum_y=z(), sum_z=z(),
                        center=torch.zeros(batch, 2, dtype=dtype,
                                           device=device),
                        resolution=resolution)


def shift_point_map(grid: PointMapGrid, new_center_xy: torch.Tensor,
                    resolution: float | None = None) -> PointMapGrid:
    """Re-centre on new_center_xy (B, 2) by whole cells, clearing the band
    that wraps in."""
    d, center = shift_step(grid.center, new_center_xy,
                           resolution or grid.resolution)
    fresh = fresh_mask(d, *grid.count.shape[1:], rows=grid.rows)
    count, sx, sy, sz = (torch.where(fresh, 0.0, a) for a in roll_cells(
        (grid.count, grid.sum_x, grid.sum_y, grid.sum_z), d, grid.rows))
    return grid.replace(count=count, sum_x=sx, sum_y=sy, sum_z=sz,
                        center=center)


def offset_point_map_z(grid: PointMapGrid, dz: torch.Tensor) -> PointMapGrid:
    """Shift every stored point's z by dz (B,): the graph's z pose offset
    (MLS::offsetMap). sum_z holds absolute z sums, so the shift is
    sum_z + dz * count; empty cells stay as they are."""
    return grid.replace(sum_z=grid.sum_z + dz[:, None, None] * grid.count)


def update_point_map(grid: PointMapGrid, xyz_world: torch.Tensor,
                     valid: torch.Tensor,
                     resolution: float | None = None) -> PointMapGrid:
    """Fold world-frame points (B, N, 3) into the grid, z included: the
    cloud form of update_point_map_xy."""
    return update_point_map_xy(grid, xyz_world[..., 0], xyz_world[..., 1],
                               xyz_world[..., 2], valid, resolution)


def update_point_map_xy(grid: PointMapGrid, qx: torch.Tensor,
                        qy: torch.Tensor, qz, valid: torch.Tensor,
                        resolution: float | None = None) -> PointMapGrid:
    """Fold world-frame x / y planes (B, N) into the grid. qz None (the 2D
    path) leaves sum_z untouched."""
    G = grid.count.shape[-1]
    res = resolution or grid.resolution
    rx = qx - grid.center[:, 0:1]
    ry = qy - grid.center[:, 1:2]
    cx = torch.floor(true_div(rx, res)).to(torch.int32) + G // 2
    cy = torch.floor(true_div(ry, res)).to(torch.int32) + G // 2
    ox = rx - (cx.to(rx.dtype) - G // 2 + 0.5) * res
    oy = ry - (cy.to(ry.dtype) - G // 2 + 0.5) * res
    chans = (None, ox, oy) + (() if qz is None else (qz,))
    acc = scatter_add_2d_multi(cx, cy, chans, valid, grid.count.shape[1:],
                               rows=grid.rows)
    return grid.replace(
        count=grid.count + acc[0], sum_x=grid.sum_x + acc[1],
        sum_y=grid.sum_y + acc[2],
        sum_z=grid.sum_z if qz is None else grid.sum_z + acc[3])


def export_point_planes(grid: PointMapGrid, capacity: int,
                        min_count: float = 1.0, ga_threshold: int = 2):
    """Occupied-cell centroids as (x, y, z, ga, valid) planes (B, capacity).

    GA per cell: >= ga_threshold empty 8-neighbours, interior cells only.
    Overflow keeps the `capacity` most observed cells; equal counts go to
    the lower flat cell index, which is jax.lax.top_k's order (and what
    slam_tpu's approx_max_k export gives off the TPU). A stable descending
    sort fixes that order; torch.topk leaves it undefined. A grid split by
    rows exports the whole grid's cells on every rank of its sp group."""
    rows = grid.rows
    B, h, G = grid.count.shape
    H = whole_rows(rows, h)
    occ = grid.count >= min_count
    box = neighbor_sum_2d((~occ).to(torch.float32), rows=rows)
    ii = row_index(rows, h, occ.device)
    jj = torch.arange(G, device=occ.device)
    inner = ((ii > 0) & (ii < H - 1))[:, None] & ((jj > 0) & (jj < G - 1))
    ga = occ & inner & (box >= ga_threshold)

    score = torch.where(occ, grid.count, 0.0).reshape(B, -1)
    v, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    v, idx = v[:, :capacity], idx[:, :capacity]
    cells = gather_cells_2d(
        (grid.count, grid.sum_x, grid.sum_y, grid.sum_z,
         ga.to(torch.float32)), idx // G, idx % G)
    if rows is not None:
        v, (idx, *cells) = merge_top(v, [idx + rows.r0 * G, *cells],
                                     capacity, rows)
    n, ox, oy, oz, g = cells
    sel = v >= min_count
    ci = idx // G
    cj = idx % G
    cnt = torch.clamp(n, min=1.0)
    res = grid.resolution
    ctr_x = (ci - G // 2 + 0.5) * res + grid.center[:, 0:1]
    ctr_y = (cj - G // 2 + 0.5) * res + grid.center[:, 1:2]
    x = torch.where(sel, ctr_x + ox / cnt, 0.0)
    y = torch.where(sel, ctr_y + oy / cnt, 0.0)
    z = torch.where(sel, oz / cnt, 0.0)
    ga_pt = sel & (g > 0.5)
    return x, y, z, ga_pt, sel


def export_points(grid: PointMapGrid, capacity: int, min_count: float = 1.0,
                  ga_threshold: int = 2) -> PointCloud:
    """export_point_planes packed into a PointCloud."""
    x, y, z, ga_pt, sel = export_point_planes(grid, capacity, min_count,
                                              ga_threshold)
    flags = torch.where(ga_pt, PointCloud.FLAG_GA, 0).to(torch.int32)
    return PointCloud(xyz=torch.stack([x, y, z], -1), valid=sel, flags=flags)
