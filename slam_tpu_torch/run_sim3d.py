"""3D Velodyne SLAM over procedural terrain (BASELINE config 2) —
counterpart of examples/run_sim3d.py.

    python3 -m slam_tpu_torch.run_sim3d [--steps 60] [--out /tmp/slam3d]
        [--metrics] [--save-csv PATH] [--ref-scale] [--device cpu]

One robot runs the 3D tick (GP-INSAC ground segmentation, the obstacle
scene, class-constrained ICP, wheel-contact height interpolation, the
obstacle and ground point maps, occupancy) at sim3d_config (kernel K1 on
the card), or with --ref-scale at the reference's working point
(ref_scale_config: 20,480-ray scans) with the "grid" matcher, which runs
no kernel. Prints the xy ATE and the mean z error after a warm-up, and
renders the trajectory and the drivability grid. --metrics records each
tick's figures through `metrics.emit`, a host sync a tick on the card.
On the card unless given --device cpu; it raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.config import ref_scale_config, sim3d_config
from slam_tpu_torch.pipeline import slam3d
from slam_tpu_torch.sim import world3d


def config(ref_scale: bool = False):
    """sim3d_config, or ref_scale_config with the "grid" matcher."""
    if ref_scale:
        cfg = ref_scale_config()
        return cfg.replace(icp=dataclasses.replace(cfg.icp, matcher="grid"))
    return sim3d_config()


def run(cfg, world, state, ground_map, steps: int,
        generator: torch.Generator) -> dict:
    """Roll one robot's `state` and `ground_map` through `steps` ticks of
    `world`, the sensor noise drawn from `generator`. Returns the printed
    numbers (xy_ate, z_err: RMS xy and mean |z| error after min(8,
    steps // 4) ticks; icp_ok: the last tick registered) and the run
    (final, est, true: robot 0's (T, 4) trajectories)."""
    st, gm, (est, true, _) = slam3d.rollout_3d(state, world, ground_map, cfg,
                                               steps, generator)
    est = est[0].cpu().numpy()
    true = true[0].cpu().numpy()
    warm = min(8, steps // 4)
    xy_err = np.linalg.norm(est[warm:, :2] - true[warm:, :2], axis=1)
    z_err = np.abs(est[warm:, 3] - true[warm:, 3])
    return dict(xy_ate=float(np.sqrt(np.mean(xy_err ** 2))),
                z_err=float(z_err.mean()), icp_ok=bool(st.scan_reg_ok[0]),
                final=st, ground_map=gm, est=est, true=true)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default="/tmp/slam3d")
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--save-csv", default=None, metavar="PATH",
                    help="log the estimated trajectory as the reference's "
                         "x, y, yaw CSV (global_generate.cpp:194)")
    ap.add_argument("--ref-scale", action="store_true",
                    help="run at the reference's working point: 20,480-ray "
                         "scans, 72x200 polar grid, 20k pts/class ICP "
                         "(config.ref_scale_config), matcher \"grid\"")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from slam_tpu_torch.utils import metrics
    from slam_tpu_torch.utils.viz import render_grid, render_trajectory

    device = default_device(args.device)
    if args.metrics:
        metrics.enable()
    cfg = config(args.ref_scale)
    world = world3d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    gen = torch.Generator(device).manual_seed(0)
    st = slam3d.init_state_3d(cfg, 1, world, device=device, generator=gen)
    gm = slam3d.init_ground_map(cfg, 1, device=device)
    r = run(cfg, world, st, gm, args.steps, gen)
    print(f"{args.steps} steps on {device.type}  |  "
          f"xy ATE {r['xy_ate']:.3f} m  |  z err mean {r['z_err']:.3f} m  |  "
          f"icp ok {r['icp_ok']}")

    if args.save_csv:
        from slam_tpu_torch.utils.trajectory import save_trajectory_csv
        n = save_trajectory_csv(args.save_csv, r["est"])  # x, y, yaw, z
        print(f"trajectory csv ({n} rows) -> {args.save_csv}")

    os.makedirs(args.out, exist_ok=True)
    render_trajectory(os.path.join(args.out, "trajectory.png"),
                      r["est"][:, :2], r["true"][:, :2])
    render_grid(os.path.join(args.out, "drivability.png"),
                r["final"].local_map.drivable[0], title="drivability")
    print(f"renders -> {args.out}/")

    if args.metrics:
        s = metrics.summary().get("slam_step_3d", {})
        if s:
            print(f"metrics: icp ok-rate {s.get('icp_ok', 0):.3f}  |  "
                  f"scene pts {s.get('scene_points', 0):.0f}  |  "
                  f"residual {s.get('mean_residual', 0):.4f}")


if __name__ == "__main__":
    main()
