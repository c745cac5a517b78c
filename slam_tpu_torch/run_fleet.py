"""A robot fleet with throughput reporting — counterpart of
examples/run_fleet.py.

    python3 -m slam_tpu_torch.run_fleet [--batch 1024] [--steps 40]
        [--matcher fused|points|grid|particle] [--shared-map] [--metrics]
        [--debug-nans] [--device cpu]

Config 1's fleet (sim2d_config) with the scan-to-map matcher of the
config or of --matcher: "fused" on kernel K1, "points" on K4, "particle"
on K5, "grid" on none. --shared-map merges the fleet's maps into one
world-aligned grid every 4-tick macro: with "particle" that is config 5
(`fleet_rollout_shared`: the robots carry no grid and score the one
shared grid); with a cloud matcher every robot folds its scans into its
own copy of the shared grid, each macro the robots' additions are summed
into it by `merge_maps` (`fold_fleet_grids`), every robot gets its own
copy of the result, and the registration target is re-exported from it.
Each run is made twice, the second continuing the first: the first
builds the kernels and warms the allocator, and only the second is
timed (`Throughput` waits for the card before it reads the clock).

--metrics records each tick's registration figures through
`metrics.emit`, which on the card copies them to the host: a sync a tick.
--debug-nans checks the state finite after every tick (`metrics.
nan_debug`), a host read a tick. On the card unless given --device cpu;
it raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.mapping.point_map import (PointMapGrid, export_points,
                                              init_point_map)
from slam_tpu_torch.parallel.shared_map import (fleet_rollout_shared,
                                                merge_maps)
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.sim import world2d
from slam_tpu_torch.utils import metrics
from slam_tpu_torch.utils.profiling import Throughput


def _per_robot(t: torch.Tensor, batch: int) -> torch.Tensor:
    """A copy of batch-1 `t` for each robot, in storage of its own (an
    expanded view would make every robot's in-place write land in one
    place)."""
    return t.repeat((batch,) + (1,) * (t.dim() - 1))


def _channels(g: PointMapGrid):
    return g.count, g.sum_x, g.sum_y, g.sum_z


def fold_fleet_grids(shared: PointMapGrid,
                     grids: PointMapGrid) -> PointMapGrid:
    """The batch-1 shared grid plus what the robots added to it: each
    robot's grid (B, G, G) is a copy of `shared` into which it folded its
    own scans, and merge_maps sums the differences, so that every
    observation counts once."""
    added = merge_maps(grids.replace(**{
        k: g - s for k, g, s in zip(("count", "sum_x", "sum_y", "sum_z"),
                                    _channels(grids), _channels(shared))}))
    return added.replace(**{
        k: a + s for k, a, s in zip(("count", "sum_x", "sum_y", "sum_z"),
                                    _channels(added), _channels(shared))})


def shared_cloud_macros(states, world, cfg, n_macro: int,
                        generator: torch.Generator):
    """n_macro macros of 4 ticks for robots whose grids hold the same map
    (the fleet's shared grid; zero at the start): each robot registers
    against the target exported from it and folds its scans into its own
    copy, and after the macro every robot gets a copy of the shared grid
    with all robots' new scans (fold_fleet_grids) and of its export.

    slam_tpu's example merges by summing the robots' grids outright, which
    counts the previous merge B times over: its counts grow B-fold a
    macro, the newest scans weigh 1/B of the old, and at B = 1024 the
    counts leave f32's range after ~13 macros. The two agree on the first
    macro and at B = 1. Returns (states, (est, true)), trajectories (B,
    4 n_macro, 3)."""
    B = states.pose.shape[0]
    est, true = [], []
    for _ in range(n_macro):
        g = states.map_grid
        shared = PointMapGrid(
            count=g.count[:1].clone(), sum_x=g.sum_x[:1].clone(),
            sum_y=g.sum_y[:1].clone(), sum_z=g.sum_z[:1].clone(),
            center=g.center[:1], resolution=g.resolution)
        for _ in range(4):
            states = slam2d.slam_step(states, world, cfg, generator,
                                      refresh_map=False, shift_maps=False)
            est.append(states.pose[:, :3])
            true.append(states.true_pose[:, :3])
        merged = fold_fleet_grids(shared, states.map_grid)
        cloud = export_points(merged, cfg.cloud.map_capacity,
                              ga_threshold=cfg.icp.ga_threshold)
        states = states.replace(
            map_grid=merged.replace(**{
                k: _per_robot(getattr(merged, k), B)
                for k in ("count", "sum_x", "sum_y", "sum_z", "center")}),
            map_cloud=cloud.replace(xyz=_per_robot(cloud.xyz, B),
                                    valid=_per_robot(cloud.valid, B),
                                    flags=_per_robot(cloud.flags, B)))
    return states, (torch.stack(est, 1), torch.stack(true, 1))


def run(cfg, world, states, steps: int, generator: torch.Generator,
        shared_map: bool = False) -> dict:
    """Run the fleet `states` (B robots) twice over `steps` ticks (rounded
    up to 4-tick macros), the second continuing the first, and time the
    second. Returns rate (robot-steps/s), median_err (the fleet's median
    xy error at the end), icp_ok (robots whose last registration was
    accepted), executed (ticks a run), the final states and the whole
    mission's trajectories est, true (B, 2 executed, 3)."""
    B = states.pose.shape[0]
    n_macro = max(1, -(-steps // 4))
    executed = 4 * n_macro
    if shared_map and cfg.icp.matcher == "particle":
        shared = init_point_map(1, cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0],
                                device=states.pose.device)

        def go(s):
            st, sh, traj = fleet_rollout_shared(s[0], s[1], world, cfg,
                                                n_macro, generator=generator)
            return (st, sh), traj
        carry = (states.replace(map_grid=None), shared)
    elif shared_map:
        def go(s):
            return shared_cloud_macros(s, world, cfg, n_macro, generator)
        carry = states
    else:
        def go(s):
            return slam2d.rollout(s, world, cfg, executed, generator)
        carry = states
    carry, (est0, true0) = go(carry)                   # warm-up
    t = Throughput(batch=B)
    carry, (est1, true1) = go(carry)
    t.tick(executed)
    rate = t.robot_steps_per_sec
    final = carry[0] if isinstance(carry, tuple) else carry
    err = (final.pose[:, :2] - final.true_pose[:, :2]).norm(dim=-1)
    return dict(rate=rate, median_err=float(np.median(err.cpu().numpy())),
                icp_ok=int(final.scan_reg_ok.sum()), batch=B,
                executed=executed, final=final,
                est=torch.cat([est0, est1], 1),
                true=torch.cat([true0, true1], 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--metrics", action="store_true",
                    help="scalar metrics per step (ICP ok-rate, "
                         "correspondences, residual)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise at the first tick whose state is not finite")
    ap.add_argument("--matcher", default=None,
                    choices=("fused", "points", "grid", "particle"),
                    help="scan-to-map matching engine (default: config)")
    ap.add_argument("--shared-map", action="store_true",
                    help="merge the fleet's maps into one shared "
                         "world-aligned grid each macro (BASELINE config 5)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    use_ring = False
    if args.metrics:
        # host records where the backend can reach the host (the port
        # always can); the device ring otherwise, drained after the run
        use_ring = not metrics.enable()
    if args.debug_nans:
        metrics.nan_debug(True)

    cfg = sim2d_config()
    if args.matcher:
        cfg = dataclasses.replace(
            cfg, icp=dataclasses.replace(cfg.icp, matcher=args.matcher))
    world = world2d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    gen = torch.Generator(device).manual_seed(0)
    states = slam2d.init_state(cfg, args.batch, device=device, generator=gen,
                               with_metrics_ring=use_ring,
                               metrics_ring_capacity=max(32, 2 * args.steps))
    r = run(cfg, world, states, args.steps, gen, shared_map=args.shared_map)
    print(f"{r['rate']:,.0f} robot-steps/s on {device.type}  |  fleet "
          f"median xy error {r['median_err']:.3f} m  |  icp ok "
          f"{r['icp_ok']}/{args.batch}")
    if args.shared_map and cfg.icp.matcher == "particle":
        return
    if args.metrics and use_ring:
        recs = metrics.drain_ring(r["final"].metrics_ring)
        ok = np.mean([x["icp_ok"] for x in recs]) if recs else float("nan")
        nc = np.mean([x["num_corr"] for x in recs]) if recs else float("nan")
        mr = np.mean([x["mean_residual"] for x in recs]) if recs \
            else float("nan")
        print(f"device-ring metrics over {len(recs)} records: "
              f"icp ok-rate {ok:.3f}  |  mean correspondences {nc:.1f}  |  "
              f"mean residual {mr:.4f} m^2")
    elif args.metrics:
        s = metrics.summary().get("slam_step", {})
        nan = float("nan")
        # a record is one tick's means over the fleet
        n = sum(1 for x in metrics.records() if x["name"] == "slam_step")
        print(f"metrics over {n} records ({n} steps): "
              f"icp ok-rate {s.get('icp_ok', nan):.3f}  |  "
              f"mean correspondences {s.get('num_corr', nan):.1f}  |  "
              f"mean residual {s.get('mean_residual', nan):.4f} m^2")


if __name__ == "__main__":
    main()
