"""Where a tick's device time goes, on the card: torch.profiler over a few
macros of config 1 (slam2d.rollout, "fused", B = 1024, or with
`--config 1points` the "points" matcher: icp_fit on K4, or with
`--config 1grid` the "grid" matcher), config 5
(shared_map.fleet_rollout_shared, "particle", stride 4, B = 1024), config
2 (slam3d.rollout_3d, "fused": at sim3d_config with K1, B = 128, or at
ref_scale_config with K3, B = 16, or with `--config refgrid` the "grid"
matcher at ref_scale_config, bench.py's bench_ref_scale, B = 16) or
config 4 (slam2d.rollout_with_graph at sim2d_graph_config, B = 256,
macros of 8 ticks and a graph tick: K1 on the ticks, K2 and K4 on the
graph tick's edges) or config 3 (macros of
4 "fused" ticks at sim2d_reloc_config, B = 128, each folding the last
scene into the robots' MLS grids and relocalizing the lost robots; robot
0's belief is kidnapped and flagged lost in the third macro of every
4-macro window, as bench.py's bench_mls_reloc does once a block) or
config 4 in 3D (`--config 3d-graph`: slam3d.rollout_3d_with_graph at
ref_scale_graph_config, B = 16, macros of 8 graph-mode ticks on K3 and a
graph tick whose 2,048-point keyframe edges go to K3 as well).

    python3 -m slam_tpu_torch.profile_tick --config 5
    # or 1, 1points, 1grid, 5, 2, ref, refgrid, 4, 3, 3d-graph

The stages are the package's own spans (utils/profiling.stage: raycast,
ekf, ground_seg, scene_build, registration, height, map_update,
map_macro, the graph tick's graph.*, the relocalization's reloc.*, and
the tick's and the rollout's own spans for the glue between them), which
profiling.attribute reduces: a kernel counts toward the innermost span it
was launched in. It prints the unprofiled ms/tick of three windows, then
per span the kernel time per tick and the device's idle gaps per tick
under it, the top kernels by name, and the device's idle share two ways:
against the profiled window's timeline (first kernel start to last kernel
end), which the profiler's own host cost lengthens, and against the
median unprofiled ms/tick (1 - busy / wall), which assumes the profiler
leaves the kernels' own times alone. The chrome trace and a JSON summary
go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile

import torch

from slam_tpu_torch import config as cfg_mod
from slam_tpu_torch.geometry import se2_apply
from slam_tpu_torch.mapping import mls as mls_mod
from slam_tpu_torch.mapping.point_map import init_point_map
from slam_tpu_torch.parallel import shared_map
from slam_tpu_torch.pipeline import relocalize, slam2d, slam3d
from slam_tpu_torch.sim import world2d, world3d
from slam_tpu_torch.utils import profiling

MACROS = 2          # profiled macros, and each timed window's (a macro is
                    # 4 ticks; 8 and a graph tick for config 4); config 3
                    # takes 4, the third kidnapping robot 0
KIDNAP_AT = 2       # config 3: the macro of a window that kidnaps robot 0
KIDNAP = (8.0, -5.0, 1.2)

def kidnap(state, robot: int = 0):
    """The state with one robot's belief (EKF mean and pose) moved by
    KIDNAP: x, y and yaw, the yaw not wrapped (bench.py's teleport)."""
    mu, pose = state.ekf.mu.clone(), state.pose.clone()
    for i, j, v in ((0, 0, KIDNAP[0]), (1, 1, KIDNAP[1]), (6, 2, KIDNAP[2])):
        mu[robot, i] += v
        pose[robot, j] += v
    return state.replace(ekf=state.ekf.replace(mu=mu), pose=pose)


def mls_macro(state, grid, world, cfg, gen, kidnap_robot0=False):
    """One macro of config 3, as bench.py's bench_mls_reloc builds it: with
    kidnap_robot0, robot 0's belief jumps by KIDNAP and robot 0 is flagged
    lost; 4 fused ticks; the last scene folded into the MLS grids at the
    fused pose; the lost robots relocalized. Returns (state, grid, (est,
    true), the state the relocalization gate was given, lost)."""
    if kidnap_robot0:
        state = kidnap(state)
    state, traj = slam2d.rollout(state, world, cfg, 4, gen)
    scene = state.prev_scene
    xy = se2_apply(state.pose[:, :3], scene.xyz[..., :2])
    with profiling.stage("mls_fold"):
        grid = mls_mod.add_to_mls(grid, scene.replace(
            xyz=torch.cat([xy, scene.xyz[..., 2:]], -1)), cfg.mls)
    lost = ~state.scan_reg_ok
    if kidnap_robot0:
        lost = lost.clone()
        lost[0] = True
    return (relocalize.fleet_relocalize_if_lost(state, cfg, lost=lost), grid,
            traj, state, lost)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("1", "1points", "1grid", "5", "2",
                                         "ref", "refgrid", "4", "3",
                                         "3d-graph"), default="5")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    three_d = args.config in ("2", "ref", "refgrid")
    per_macro = 8 if args.config in ("4", "3d-graph") else 4
    macros = 4 if args.config == "3" else MACROS
    if args.config == "3":
        cfg = cfg_mod.sim2d_reloc_config()
        batch = 128
        world = world2d.make_world(gen, cfg.sim, device=dev)
        state = slam2d.init_state(cfg, batch, device=dev, generator=gen)
        aux = mls_mod.init_mls(cfg.mls, batch, device=dev)
    elif args.config == "4":
        cfg = cfg_mod.sim2d_graph_config()
        batch = 256
        world = world2d.make_world(gen, cfg.sim, device=dev)
        state = slam2d.init_state(cfg, batch, device=dev, generator=gen,
                                  with_graph=True)
        aux = None
    elif args.config == "3d-graph":
        cfg = cfg_mod.ref_scale_graph_config()
        batch = 16
        world = world3d.make_world(gen, cfg.sim, device=dev)
        state = slam3d.init_state_3d(cfg, batch, world, device=dev,
                                     generator=gen, with_graph=True)
        aux = slam3d.init_ground_map(cfg, batch, device=dev)
    elif three_d:
        cfg = (cfg_mod.sim3d_config() if args.config == "2"
               else cfg_mod.ref_scale_config())
        if args.config == "refgrid":
            cfg = cfg.replace(icp=dataclasses.replace(cfg.icp,
                                                      matcher="grid"))
        batch = 128 if args.config == "2" else 16
        world = world3d.make_world(gen, cfg.sim, device=dev)
        state = slam3d.init_state_3d(cfg, batch, world, device=dev,
                                     generator=gen)
        aux = slam3d.init_ground_map(cfg, batch, device=dev)
    else:
        cfg = cfg_mod.sim2d_config()
        if args.config in ("1points", "1grid"):
            cfg = dataclasses.replace(cfg, icp=dataclasses.replace(
                cfg.icp, matcher=args.config[1:]))
        if args.config == "5":
            cfg = dataclasses.replace(
                cfg, icp=dataclasses.replace(cfg.icp, matcher="particle"),
                pf=dataclasses.replace(cfg.pf, score_stride=4))
        batch = 1024
        world = world2d.make_world(gen, cfg.sim, device=dev)
        state = slam2d.init_state(cfg, batch, device=dev, generator=gen)
        aux = init_point_map(1, cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0],
                             device=dev)

    def run(s, a, macros):
        if args.config == "3":
            for m in range(macros):
                s, a = mls_macro(s, a, world, cfg, gen, m == KIDNAP_AT)[:2]
        elif args.config == "4":
            s, _ = slam2d.rollout_with_graph(s, world, cfg, macros, gen,
                                             per_macro)
        elif args.config == "3d-graph":
            s, a, _ = slam3d.rollout_3d_with_graph(s, world, a, cfg, macros,
                                                   gen, per_macro)
        elif three_d:
            s, a, _ = slam3d.rollout_3d(s, world, a, cfg, 4 * macros, gen)
        elif args.config == "5":
            s, a, _ = shared_map.fleet_rollout_shared(s, a, world, cfg,
                                                      macros, generator=gen)
        else:
            s, _ = slam2d.rollout(s, world, cfg, 4 * macros, gen)
        return s, a

    state, aux = run(state, aux, KIDNAP_AT + 1 if args.config == "3"
                     else 1)                                 # warm-up
    windows = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        state, aux = run(state, aux, macros)
        e1.record()
        torch.cuda.synchronize()
        windows.append(e0.elapsed_time(e1) / (per_macro * macros))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        state, aux = run(state, aux, macros)
        torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_config{args.config}.json")
    with tempfile.TemporaryDirectory() as d:
        tmp = os.path.join(d, "trace.json")
        prof.export_chrome_trace(tmp)
        with open(tmp) as f:
            trace = json.load(f)
    with open(path, "w") as f:
        json.dump(trace, f)
    ticks = per_macro * macros
    r = profiling.attribute(trace)
    kern_ms = r["busy_us"] / 1e3 / ticks
    line_ms = r["timeline_us"] / 1e3 / ticks
    wall_ms = sorted(windows)[len(windows) // 2]
    print(f"config {args.config}, B={batch}, {card}", flush=True)
    print(f"unprofiled ms/tick over three {ticks}-tick windows: "
          f"{', '.join(f'{w:.3f}' for w in windows)}")
    print(f"profiled: {line_ms:.3f} ms/tick of timeline, {kern_ms:.3f} "
          f"ms/tick device busy, idle share "
          f"{1 - kern_ms / line_ms if line_ms else float('nan'):.3f} of the "
          f"timeline, {1 - kern_ms / wall_ms:.3f} of the unprofiled "
          f"{wall_ms:.3f} ms/tick, {r['ops'] / ticks:.2f} device ops "
          f"per tick")
    print("span | kernel ms/tick | idle ms/tick")
    for span, us in sorted(r["kernel_us"].items(), key=lambda kv: -kv[1]):
        print(f"  {span} | {us / 1e3 / ticks:.3f} | "
              f"{r['gaps_us'].get(span, 0.0) / 1e3 / ticks:.3f}")
    for span in sorted(set(r["gaps_us"]) - set(r["kernel_us"])):
        print(f"  {span} | 0.000 | {r['gaps_us'][span] / 1e3 / ticks:.3f}")
    print("kernel | ms/tick")
    for name, us in sorted(r["by_name_us"].items(),
                           key=lambda kv: -kv[1])[:15]:
        print(f"  {name[:80]} | {us / 1e3 / ticks:.3f}")
    summary = dict(config=args.config, batch=batch, card=card,
                   unprofiled_ms_per_tick=windows,
                   timeline_ms_per_tick=line_ms, busy_ms_per_tick=kern_ms,
                   idle_share_timeline=1 - kern_ms / line_ms,
                   idle_share_unprofiled=1 - kern_ms / wall_ms,
                   stages_ms_per_tick={k: v / 1e3 / ticks
                                       for k, v in r["kernel_us"].items()},
                   idle_ms_per_tick={k: v / 1e3 / ticks
                                     for k, v in r["gaps_us"].items()})
    with open(os.path.join(args.out, f"profile_config{args.config}.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
