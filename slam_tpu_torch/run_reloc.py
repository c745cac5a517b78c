"""Kidnapped-robot relocalization against the built map — counterpart of
examples/run_reloc.py.

The global_matching node's scenario (global_match.cpp:72-223): a robot
that has built a map is teleported in belief (kidnap). The FFT
correlative matcher searches every heading exhaustively and its ICP
polish (kernel K4 on the card) refines the match; on acceptance the EKF
belief snaps back. With --graph the robot maps with pose-graph SLAM (K2
on the keyframe edges) and the match is also injected as an edge from
node 0 and the keyframe history re-optimised.

    python3 -m slam_tpu_torch.run_reloc [--steps 80] [--out /tmp/reloc]
        [--kidnap DX DY DYAW] [--save-pcd PATH] [--prior-pcd PATH]
        [--graph] [--device cpu]

One robot (batch 1). On the card unless given --device cpu; it raises
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.pipeline.relocalize import (apply_relocalization,
                                                apply_relocalization_graph,
                                                relocalize)
from slam_tpu_torch.sim import world2d


def config():
    """sim2d_config with the example's global-match search: 64 headings on
    a 192-cell raster of 0.5 m, accepted at a score of 0.35."""
    c = sim2d_config()
    return dataclasses.replace(c, global_match=dataclasses.replace(
        c.global_match, num_rotations=64, grid_size=192,
        grid_resolution=0.5, accept_score=0.35))


def kidnap(st, dx: float, dy: float, dyaw: float):
    """The state with its belief moved by (dx, dy, dyaw): the EKF mean's x,
    y and yaw (entries 0, 1, 6) and the fused pose. New tensors: the
    state's own are left as they are."""
    mu_off = torch.zeros_like(st.ekf.mu)
    mu_off[:, 0], mu_off[:, 1], mu_off[:, 6] = dx, dy, dyaw
    pose_off = torch.zeros_like(st.pose)
    pose_off[:, 0], pose_off[:, 1], pose_off[:, 2] = dx, dy, dyaw
    return st.replace(ekf=st.ekf.replace(mu=st.ekf.mu + mu_off),
                      pose=st.pose + pose_off)


def run(cfg, world, state, steps: int, generator: torch.Generator,
        kidnap_by=(8.0, -5.0, 1.2), graph: bool = False,
        save_pcd: str | None = None, prior_pcd: str | None = None) -> dict:
    """Map `steps` ticks with `state` (batch 1; a pose graph for
    graph=True, in macros of 8 ticks and a graph tick), optionally save
    the map (save_pcd) or swap in a prior map (prior_pcd), kidnap the
    belief by kidnap_by, match a fresh noise-free scan taken at the true
    pose and apply the match. Returns the printed numbers: map_ate,
    steps_mapped (and keyframes, edges with graph), saved_points,
    prior_points, err0 / err1 (the belief's distance from the truth before
    and after), score, ok, edges_after and injected (an edge was added),
    and the run (est, true, lost, fixed, true_pose)."""
    out: dict = {}
    if graph:
        st, (est, true) = slam2d.rollout_with_graph(
            state, world, cfg, -(-steps // 8), generator, graph_every=8)
        out.update(keyframes=int(st.graph.num_nodes[0]),
                   edges=int(st.graph.num_edges[0]))
    else:
        st, (est, true) = slam2d.rollout(state, world, cfg, steps, generator)
    est, true = est[0], true[0]
    out.update(steps_mapped=est.shape[0],
               map_ate=float(slam2d.ate(est[10:], true[10:])))

    if save_pcd:
        from slam_tpu_torch.utils.pcd import save_pcd as _save
        out["saved_points"] = _save(save_pcd, st.map_cloud)
    if prior_pcd:
        from slam_tpu_torch.utils.pcd import load_pcd
        prior = load_pcd(prior_pcd, capacity=st.map_cloud.capacity,
                         device=st.pose.device)
        st = st.replace(map_cloud=prior)
        out["prior_points"] = int(prior.valid.sum())

    lost = kidnap(st, *kidnap_by)
    true_pose = st.true_pose[0]
    out["err0"] = float((lost.pose[0, :2] - true_pose[:2]).norm())

    # a fresh scan at the TRUE pose, matched against the robot's own map
    ranges, hit = world2d.raycast(world, st.true_pose[:, :3], cfg.sim)
    scan_xyz, hit = world2d.scan_to_points(ranges, hit)
    scene = slam2d.build_scene(scan_xyz, hit, cfg)
    match = relocalize(lost, scene, cfg)
    out.update(score=float(match.score[0]), ok=bool(match.ok[0]), est=est,
               true=true, lost=lost.pose[0, :3], true_pose=true_pose[:3])
    if not out["ok"]:
        return out
    if graph:
        fixed = apply_relocalization_graph(lost, match, cfg)
        out["edges_after"] = int(fixed.graph.num_edges[0])
        out["injected"] = out["edges_after"] > int(lost.graph.num_edges[0])
    else:
        fixed = apply_relocalization(lost, match)
    out.update(err1=float((fixed.pose[0, :2] - true_pose[:2]).norm()),
               fixed=fixed.pose[0, :3])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--kidnap", type=float, nargs=3, default=[8.0, -5.0, 1.2],
                    help="dx dy dyaw applied to the belief")
    ap.add_argument("--out", default="/tmp/reloc")
    ap.add_argument("--save-pcd", default=None, metavar="PATH",
                    help="export the built map as a .pcd (the reference's "
                         "global_generate save, global_generate.cpp:238)")
    ap.add_argument("--prior-pcd", default=None, metavar="PATH",
                    help="relocalize against a prior .pcd map instead of "
                         "the robot's own (loadPCDFile, global_match.cpp:258)")
    ap.add_argument("--graph", action="store_true",
                    help="map with pose-graph SLAM and apply the match as "
                         "an Edge{from: 0} loop closure + re-optimization "
                         "(apply_relocalization_graph)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = config()
    world = world2d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    gen = torch.Generator(device).manual_seed(0)
    st = slam2d.init_state(cfg, 1, device=device, generator=gen,
                           with_graph=args.graph)
    r = run(cfg, world, st, args.steps, gen, kidnap_by=args.kidnap,
            graph=args.graph, save_pcd=args.save_pcd,
            prior_pcd=args.prior_pcd)
    if args.graph:
        print(f"mapped {r['steps_mapped']} steps with pose graph "
              f"({r['keyframes']} keyframes, {r['edges']} edges), "
              f"ATE {r['map_ate']:.3f} m")
    else:
        print(f"mapped {args.steps} steps, ATE {r['map_ate']:.3f} m")
    if args.save_pcd:
        print(f"saved {r['saved_points']}-point map to {args.save_pcd}")
    if args.prior_pcd:
        print(f"relocalization target <- {args.prior_pcd} "
              f"({r['prior_points']} points)")
    print(f"kidnapped: belief now {r['err0']:.1f} m from truth")
    if not r["ok"]:
        print(f"relocalization REJECTED (score {r['score']:.3f}) — "
              "state left untouched (the reference retries next scan)")
        return
    if args.graph:
        print(f"loop-closure edge from node 0 injected; graph re-optimized "
              f"({r['edges_after']} edges)")
    print(f"relocalized: score {r['score']:.3f}, "
          f"belief error {r['err0']:.1f} m -> {r['err1']:.2f} m")

    from slam_tpu_torch.utils import viz   # .npy dumps without matplotlib
    os.makedirs(args.out, exist_ok=True)
    viz.render_trajectory(os.path.join(args.out, "reloc.png"), r["est"],
                          r["true"])
    print(f"renders in {args.out} (lost {r['lost'][:2].cpu().numpy()}, "
          f"fixed {r['fixed'][:2].cpu().numpy()}, true "
          f"{r['true_pose'][:2].cpu().numpy()})")


if __name__ == "__main__":
    main()
