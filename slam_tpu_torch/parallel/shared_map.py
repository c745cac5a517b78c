"""One map shared by the fleet, BASELINE config 5 — counterpart of
slam_tpu/parallel/shared_map.py (`merge_maps`, `fleet_rollout_shared`).

The point-map grid is an additive statistic (counts and offset sums), so
world-aligned grids merge by summing. In the fleet rollout the robots carry
no grid at all: the particle matcher scores every robot against the one
shared grid (batch 1, never copied per robot), and once per macro the
whole fleet's registered scans are scattered into it. The multi-device
merger (`make_shared_map_merger`, a psum over a device mesh) belongs to the
multi-device slice.
"""

from __future__ import annotations

import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.geometry import se2_apply_xy
from slam_tpu_torch.mapping.point_map import (PointMapGrid,
                                              update_point_map_xy)
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.utils import metrics


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
        resolution=grids.resolution)


def fold_scans(shared: PointMapGrid, qx: torch.Tensor, qy: torch.Tensor,
               valid: torch.Tensor) -> PointMapGrid:
    """Fold a macro's registered world-frame scans, planes (B, T, N), into
    the batch-1 shared grid in one scatter."""
    return update_point_map_xy(shared, qx.reshape(1, -1), qy.reshape(1, -1),
                               None, valid.reshape(1, -1), shared.resolution)


def fleet_rollout_shared(states, shared: PointMapGrid, world, cfg,
                         num_macro: int, ticks_per_macro: int = 4,
                         generator: torch.Generator | None = None):
    """Fleet rollout against one shared map (cfg.icp.matcher "particle").

    `shared` is a batch-1 PointMapGrid at a fixed centre. Each tick runs
    slam_step with incremental_map=False and the shared grid as the
    particle matcher's target; once per macro, the B x ticks_per_macro
    registered scans (each at its registration pose where accepted, else
    at the EKF pose) are folded into the shared grid in one scatter. The
    robots' own map grids are dropped.

    Random draws come from `generator`; without one, a fresh generator on
    the card (the states must then lie there). Returns (final_states,
    shared, (est, true)) with trajectories (B, num_macro * ticks_per_macro,
    3). Under metrics.nan_debug the states and the shared grid are checked
    finite after every tick."""
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
    for _ in range(num_macro):
        qx, qy, qv = [], [], []
        for _ in range(ticks_per_macro):
            states = slam2d.slam_step(states, world, cfg, generator,
                                      incremental_map=False,
                                      refresh_map=False, shift_maps=False,
                                      pf_target=shared)
            metrics.check_finite(len(est), state=states, shared=shared)
            sc = states.prev_scene
            mp = torch.where(states.scan_reg_ok[:, None],
                             states.scan_reg_pose[:, :3], states.pose[:, :3])
            x, y = se2_apply_xy(mp, sc.xyz[..., 0], sc.xyz[..., 1])
            qx.append(x)
            qy.append(y)
            qv.append(sc.valid)
            est.append(states.pose[:, :3])
            true.append(states.true_pose[:, :3])
        shared = fold_scans(shared, torch.stack(qx, 1), torch.stack(qy, 1),
                            torch.stack(qv, 1))
    return states, shared, (torch.stack(est, 1), torch.stack(true, 1))
