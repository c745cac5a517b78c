"""One map shared by the fleet, BASELINE config 5 — counterpart of
slam_tpu/parallel/shared_map.py (`merge_maps`, `make_shared_map_merger`,
`fleet_rollout_shared`).

The point-map grid is an additive statistic (counts and offset sums), so
world-aligned grids merge by summing. In the fleet rollout the robots carry
no grid at all: the particle matcher scores every robot against the one
shared grid (batch 1, never copied per robot), and once per macro the
whole fleet's registered scans are folded into it. Over a dp mesh
(parallel/mesh.py) each rank steps its own robots against its replica of
the shared grid, and one all-reduce a macro sums the ranks' folds into
every replica: the psum GSPMD inserts in slam_tpu. `make_shared_map_merger`
merges grids held across ranks the same way, one all-reduce of the four
channels.

On an sp > 1 mesh the ranks of a dp row hold the same robots, their
local_map split by rows (parallel/rows.py), and every rank keeps the whole
shared grid: only the row's first rank contributes its macro delta to the
all-reduce (the others add zeros), so the replicas stay bit-identical even
where two ranks' folds differ in the order of the card's atomic adds. The
merger takes grids split over dp only (slam_tpu's in_specs=P("dp")) and
all-reduces over each sp column.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from slam_tpu_torch import default_device
from slam_tpu_torch.geometry import se2_apply_xy
from slam_tpu_torch.mapping.point_map import (PointMapGrid,
                                              update_point_map_xy)
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.utils import metrics

CHANNELS = ("count", "sum_x", "sum_y", "sum_z")


def _alignment_guard(grids: PointMapGrid) -> torch.Tensor:
    """1.0 when every grid shares grid 0's centre, NaN otherwise: summing
    grids that cover different regions would be silently corrupt, so a
    misaligned merge poisons its counts instead."""
    aligned = (grids.center == grids.center[:1]).all()
    return torch.where(aligned, 1.0, float("nan"))


def merge_maps(grids: PointMapGrid) -> PointMapGrid:
    """Merge a batch of world-aligned grids (B, G, G) into one batch-1
    grid."""
    g = _alignment_guard(grids)
    return PointMapGrid(
        count=g * grids.count.sum(0, keepdim=True),
        sum_x=grids.sum_x.sum(0, keepdim=True),
        sum_y=grids.sum_y.sum(0, keepdim=True),
        sum_z=grids.sum_z.sum(0, keepdim=True),
        center=grids.center[:1],
        resolution=grids.resolution, rows=grids.rows)


def fold_scans(shared: PointMapGrid, qx: torch.Tensor, qy: torch.Tensor,
               valid: torch.Tensor) -> PointMapGrid:
    """Fold a macro's registered world-frame scans, planes (B, T, N), into
    the batch-1 shared grid in one scatter."""
    return update_point_map_xy(shared, qx.reshape(1, -1), qy.reshape(1, -1),
                               None, valid.reshape(1, -1), shared.resolution)


def _sum_over_ranks(grid: PointMapGrid, group, flag=None):
    """grid's four channels summed over `group` in one all_reduce of one
    flat buffer (with `flag`, a 0-dim tensor summed in the same buffer).
    Returns (the summed grid, the summed flag)."""
    chans = [getattr(grid, n) for n in CHANNELS]
    extra = [] if flag is None else [flag.reshape(1).to(grid.count.dtype)]
    flat = torch.cat([c.reshape(-1) for c in chans] + extra)
    dist.all_reduce(flat, group=group)
    parts = flat.split([c.numel() for c in chans] + [1] * len(extra))
    out = grid.replace(**{n: p.view_as(c)
                          for n, p, c in zip(CHANNELS, parts, chans)})
    return out, (parts[-1][0] if extra else None)


def make_shared_map_merger(mesh):
    """merge(grids) -> the merged batch-1 grid, replicated on every rank of
    the mesh: each rank sums its own world-aligned grids (B, G, G), its
    robot shard's (the grids are split over dp only; the ranks of a dp row
    hold the same ones), then one all_reduce over its sp column's dp group
    folds the four channels.

    The alignment guard is global: each rank compares its grids' centres
    with its column's first rank's robot 0 (a broadcast), and the verdict
    rides in the same all_reduce, so grids that sit elsewhere on any one
    robot shard poison the counts with NaN on every rank. The merged centre
    is robot shard 0's robot 0. Without a process group a one-rank mesh
    merges locally (merge_maps)."""

    def merge(grids: PointMapGrid) -> PointMapGrid:
        group = mesh.dp_group()
        if group is None:
            return merge_maps(grids)
        root = int(mesh.ranks[0, mesh.coords()[1]])
        center = grids.center[:1].clone()
        dist.broadcast(center, root, group=group)
        local = PointMapGrid(
            **{n: getattr(grids, n).sum(0, keepdim=True) for n in CHANNELS},
            center=center, resolution=grids.resolution, rows=grids.rows)
        merged, off = _sum_over_ranks(local, group,
                                      (grids.center != center).any())
        return merged.replace(count=torch.where(off > 0, float("nan"), 1.0)
                              * merged.count)

    return merge


def shared_macro(states, shared: PointMapGrid, world, cfg, ticks: int,
                 generator: torch.Generator, first_tick: int = 0):
    """One macro of fleet_rollout_shared on these robots: `ticks` ticks
    against `shared`, then their registered scans folded into a zero grid
    at shared's centre. Returns (states, that delta grid, (est, true)
    (B, ticks, 3)); shared + delta is what the fleet's fold gives, to the
    bit. first_tick numbers the ticks for metrics.nan_debug."""
    qx, qy, qv, est, true = [], [], [], [], []
    for t in range(ticks):
        states = slam2d.slam_step(states, world, cfg, generator,
                                  incremental_map=False, refresh_map=False,
                                  shift_maps=False, pf_target=shared)
        metrics.check_finite(first_tick + t, state=states, shared=shared)
        sc = states.prev_scene
        mp = torch.where(states.scan_reg_ok[:, None],
                         states.scan_reg_pose[:, :3], states.pose[:, :3])
        x, y = se2_apply_xy(mp, sc.xyz[..., 0], sc.xyz[..., 1])
        qx.append(x)
        qy.append(y)
        qv.append(sc.valid)
        est.append(states.pose[:, :3])
        true.append(states.true_pose[:, :3])
    zero = shared.replace(**{n: torch.zeros_like(getattr(shared, n))
                             for n in CHANNELS})
    delta = fold_scans(zero, torch.stack(qx, 1), torch.stack(qy, 1),
                       torch.stack(qv, 1))
    return states, delta, (torch.stack(est, 1), torch.stack(true, 1))


def add_grids(a: PointMapGrid, b: PointMapGrid) -> PointMapGrid:
    """a's channels plus b's (the same cells), at a's centre."""
    return a.replace(**{n: getattr(a, n) + getattr(b, n) for n in CHANNELS})


def fleet_rollout_shared(states, shared: PointMapGrid, world, cfg,
                         num_macro: int, ticks_per_macro: int = 4,
                         generator: torch.Generator | None = None,
                         mesh=None):
    """Fleet rollout against one shared map (cfg.icp.matcher "particle").

    `shared` is a batch-1 PointMapGrid at a fixed centre. Each tick runs
    slam_step with incremental_map=False and the shared grid as the
    particle matcher's target; once per macro, the B x ticks_per_macro
    registered scans (each at its registration pose where accepted, else
    at the EKF pose) are folded into the shared grid in one scatter. The
    robots' own map grids are dropped.

    With a `mesh` (parallel/mesh.py) `states` are this rank's robots
    (placed by shard_fleet: on an sp > 1 mesh their local_map holds this
    rank's rows) and `shared` its whole replica: each macro folds this
    rank's scans into a zero delta, one all_reduce over the mesh sums the
    deltas of each dp row's first rank (the row's other ranks hold the
    same robots and add zeros), and every rank adds the sum, so each
    observation counts once and the replicas stay bit-identical.

    Random draws come from `generator`; without one, a fresh generator on
    the card (the states must then lie there). Returns (final_states,
    shared, (est, true)) with trajectories (B, num_macro * ticks_per_macro,
    3), this rank's robots under a mesh. Under metrics.nan_debug the
    states and the shared grid are checked finite after every tick."""
    group, contributes = None, True
    if mesh is not None:
        group = mesh.group()
        contributes = group is None or mesh.coords()[1] == 0
    if generator is None:
        generator = torch.Generator(device=default_device())
    dev = states.pose.device
    for name, t in (("shared", shared.count), ("world", world.centers)):
        if t.device != dev:
            raise ValueError(f"fleet_rollout_shared: {name} on {t.device}, "
                             f"states on {dev}")
    if shared.count.shape[0] != 1:
        raise ValueError("fleet_rollout_shared takes a batch-1 shared grid")
    states = states.replace(map_grid=None)
    est, true = [], []
    for m in range(num_macro):
        states, delta, (e, t) = shared_macro(
            states, shared, world, cfg, ticks_per_macro, generator,
            m * ticks_per_macro)
        if group is not None:
            if not contributes:
                delta = delta.replace(**{n: torch.zeros_like(getattr(
                    delta, n)) for n in CHANNELS})
            delta = _sum_over_ranks(delta, group)[0]
        shared = add_grids(shared, delta)
        est.append(e)
        true.append(t)
    return states, shared, (torch.cat(est, 1), torch.cat(true, 1))
