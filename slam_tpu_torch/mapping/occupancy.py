"""Rolling occupancy / drivability grid — counterpart of
slam_tpu/mapping/occupancy.py (`init_occupancy`, `shift_origin`,
`add_to_occupancy`, `add_to_occupancy_xy`, `add_to_occupancy_xy2`,
`occupancy_cloud`), batched over robots.

On a grid split by rows (`grid.rows`, parallel/rows.py) the shift rolls
through a ring over the sp group, the updates scatter the points of the
slab's rows (counts and flags are per cell, so each slab's are exactly the
whole grid's), and occupancy_cloud merges each slab's top cells over the
group."""

from __future__ import annotations

import torch

from slam_tpu_torch import default_device, true_div
from slam_tpu_torch.ops.roll import fresh_mask, roll_cells, shift_step
from slam_tpu_torch.ops.scatter2d import scatter_add_2d_multi
from slam_tpu_torch.parallel.rows import merge_top, whole_rows
from slam_tpu_torch.types import OccupancyGrid, PointCloud


def init_occupancy(cfg, batch: int, device=None,
                   dtype=torch.float32) -> OccupancyGrid:
    """Empty grids, on the card unless `device` says otherwise."""
    device = default_device(device)
    shape = (batch, cfg.size_x, cfg.size_y)
    return OccupancyGrid(
        counts=torch.zeros(shape, dtype=dtype, device=device),
        drivable=torch.full(shape, -1, dtype=torch.int8, device=device),
        origin=torch.zeros(batch, 2, dtype=torch.int32, device=device),
        center=torch.zeros(batch, 2, dtype=dtype, device=device),
    )


def shift_origin(grid: OccupancyGrid, new_center_xy: torch.Tensor,
                 cfg) -> OccupancyGrid:
    """Re-centre each robot's grid on new_center_xy (B, 2) by whole cells
    and clear the cells that enter the window."""
    d, center = shift_step(grid.center, new_center_xy, cfg.resolution)
    fresh = fresh_mask(d, *grid.counts.shape[1:], rows=grid.rows)
    counts, drivable = roll_cells((grid.counts, grid.drivable), d, grid.rows)
    counts = torch.where(fresh, 0.0, counts)
    drivable = torch.where(fresh, -1, drivable)
    return grid.replace(counts=counts, drivable=drivable, center=center)


def cells_of(lx: torch.Tensor, ly: torch.Tensor, cfg):
    """Grid cell (x, y) int32 of robot-centred planes: floor of the true
    quotient by cfg.resolution (true_div: MLS's default 0.2 m is no power
    of two), offset to the grid's centre cell."""
    return (torch.floor(true_div(lx, cfg.resolution)).to(torch.int32)
            + cfg.size_x // 2,
            torch.floor(true_div(ly, cfg.resolution)).to(torch.int32)
            + cfg.size_y // 2)


def _apply_counts_drivability(grid: OccupancyGrid, delta, touch,
                              cfg) -> OccupancyGrid:
    """Add the count delta; only cells touched this scan change their
    drivability flag. Counts are unbounded, as in the reference."""
    counts = grid.counts + delta
    touched = touch > 0
    occupied = touched & (counts > cfg.min_cluster_points)
    free = touched & (counts < cfg.min_cluster_points)
    drivable = torch.where(occupied, 0, torch.where(free, 1, grid.drivable)
                           ).to(torch.int8)
    return grid.replace(counts=counts, drivable=drivable)


def add_to_occupancy_xy(grid: OccupancyGrid, lx: torch.Tensor,
                        ly: torch.Tensor, valid: torch.Tensor,
                        cfg) -> OccupancyGrid:
    """Obstacle-only occupancy update from robot-centred, world-oriented
    planes (B, N)."""
    H, W = grid.counts.shape[1:]
    x, y = cells_of(lx, ly, cfg)
    keep = valid & (lx * lx + ly * ly <= cfg.max_range * cfg.max_range)
    (touch,) = scatter_add_2d_multi(x, y, (None,), keep, (H, W),
                                    rows=grid.rows)
    return _apply_counts_drivability(grid, touch * cfg.occupancy_increment,
                                     touch, cfg)


def add_to_occupancy_xy2(grid: OccupancyGrid, ox, oy, ovalid, gx, gy, gvalid,
                         cfg) -> OccupancyGrid:
    """Obstacle and ground occupancy update (the 3D path): +increment per
    obstacle point, -decrement per ground point, from robot-centred,
    world-oriented planes (B, No) and (B, Ng)."""
    H, W = grid.counts.shape[1:]
    lx = torch.cat([ox, gx], -1)
    ly = torch.cat([oy, gy], -1)
    sign = torch.cat([
        torch.full(ox.shape, cfg.occupancy_increment, dtype=grid.counts.dtype,
                   device=ox.device),
        torch.full(gx.shape, -cfg.occupancy_decrement,
                   dtype=grid.counts.dtype, device=gx.device)], -1)
    x, y = cells_of(lx, ly, cfg)
    keep = torch.cat([ovalid, gvalid], -1) & \
        (lx * lx + ly * ly <= cfg.max_range * cfg.max_range)
    delta, touch = scatter_add_2d_multi(x, y, (sign, None), keep, (H, W),
                                        rows=grid.rows)
    return _apply_counts_drivability(grid, delta, touch, cfg)


def add_to_occupancy(grid: OccupancyGrid, obstacle: PointCloud,
                     ground: PointCloud, cfg) -> OccupancyGrid:
    """Cloud-form occupancy update: +increment per obstacle point,
    -decrement per ground point, for robot-centred, world-oriented clouds
    (B, No) and (B, Ng); points beyond cfg.max_range (by their xy norm) or
    off the grid are dropped."""
    xy = torch.cat([obstacle.xyz[..., :2], ground.xyz[..., :2]], 1)
    x, y = cells_of(xy[..., 0], xy[..., 1], cfg)
    rng = torch.sqrt((xy * xy).sum(-1))
    keep = torch.cat([obstacle.valid, ground.valid], 1) & \
        (rng <= cfg.max_range)
    sign = torch.cat([
        torch.full(obstacle.valid.shape, cfg.occupancy_increment,
                   dtype=grid.counts.dtype, device=xy.device),
        torch.full(ground.valid.shape, -cfg.occupancy_decrement,
                   dtype=grid.counts.dtype, device=xy.device)], 1)
    delta, touch = scatter_add_2d_multi(x, y, (sign, None), keep,
                                        grid.counts.shape[1:],
                                        rows=grid.rows)
    return _apply_counts_drivability(grid, delta, touch, cfg)


def occupancy_cloud(grid: OccupancyGrid, cfg, capacity: int) -> PointCloud:
    """Occupied-cell centres as a world-frame obstacle cloud (B, capacity):
    the `capacity` highest-count occupied cells, equal counts in flat cell
    order (a stable descending sort: jax.lax.top_k's order, and counts are
    integer-valued, so ties are common). Split by rows, the whole grid's
    cells on every rank of the sp group."""
    B, h, W = grid.counts.shape
    H = whole_rows(grid.rows, h)
    score = torch.where(grid.drivable == 0, grid.counts, -1.0).reshape(B, -1)
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[:, :capacity], idx[:, :capacity]
    if grid.rows is not None:
        top, (idx,) = merge_top(top, [idx + grid.rows.r0 * W], capacity,
                                grid.rows)
    sel = top > 0
    x = (idx // W - H // 2 + 0.5) * cfg.resolution + grid.center[:, 0:1]
    y = (idx % W - W // 2 + 0.5) * cfg.resolution + grid.center[:, 1:2]
    xyz = torch.stack([x, y, torch.zeros_like(x)], -1)
    return PointCloud(xyz=torch.where(sel[..., None], xyz, 0.0), valid=sel,
                      flags=torch.zeros_like(idx, dtype=torch.int32))
