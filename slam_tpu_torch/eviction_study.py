"""Eviction-policy cost study — counterpart of tools/eviction_study.py:
does keyframe eviction measurably hurt ATE when a mission outlives the
graph's capacity ~4x?

The reference keeps the full keyframe history and rebuilds the global map
from all of it after every optimisation (graph_slam.cpp:260-280); the
graph here has a fixed capacity with most-redundant-first eviction
(graph/pose_graph.py `_eviction_slot`). This runs the same long 2D
mission (one robot, macros of 4 ticks and a graph tick: K1 on the ticks,
K2 on the keyframe edges, K4 on their information) at one capacity and
prints the ATE curve by mission quarter, so the policy's cost is a
number:

    python3 -m slam_tpu_torch.eviction_study --max-nodes 16
    python3 -m slam_tpu_torch.eviction_study --max-nodes 64

(slam_tpu's tool runs one capacity a process because of a JAX re-trace
fault; the port has none, and keeps the flags.) On the card unless given
--device cpu; it raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.sim import world2d


def config(max_nodes: int, kf_dist: float = 1.0,
           degree_weight: float | None = None,
           protect_recent: int | None = None):
    """sim2d_config with the study's graph: max_nodes keyframes of 256
    points, 4 edges a node, keyframes every kf_dist metres, and the
    eviction overrides."""
    c = sim2d_config()
    gkw = dict(max_nodes=max_nodes, max_edges=4 * max_nodes,
               keyframe_points=256, knn_dist_thresh=kf_dist)
    if degree_weight is not None:
        gkw["evict_degree_weight"] = degree_weight
    if protect_recent is not None:
        gkw["evict_protect_recent"] = protect_recent
    return dataclasses.replace(c, graph=dataclasses.replace(c.graph, **gkw))


def run(cfg, world, state, macros: int, generator: torch.Generator) -> dict:
    """Run `macros` graph-mode macros of 4 ticks and a graph tick from
    `state` (batch 1, with a pose graph). Returns the printed numbers:
    steps, nodes, edges, edges_dropped, full, quarters (RMS xy error [m]
    of each quarter of the mission), overall, and cover (mean distance
    [m] from the robot to the nearest keyframe that survived, a quarter
    each)."""
    final, (est, true) = slam2d.rollout_with_graph(
        state, world, cfg, macros, generator, graph_every=4)
    est = est[0].cpu().numpy()
    true = true[0].cpu().numpy()
    T = est.shape[0]
    err = np.linalg.norm(est[:, :2] - true[:, :2], axis=1)
    q = T // 4
    quarters = [float(np.sqrt((err[i * q:(i + 1) * q] ** 2).mean()))
                for i in range(4)]
    # coverage: if this explodes while ATE does, the penalty is capacity
    # coverage (the target cannot span the mission), not the eviction
    # order
    g = final.graph
    node_xy = g.node_pose[0, :, :2].cpu().numpy()
    nv = g.node_valid[0].cpu().numpy()
    d_cover = np.linalg.norm(est[:, None, :2] - node_xy[None, nv],
                             axis=-1).min(1)
    return dict(steps=T, nodes=int(g.num_nodes[0]), edges=int(g.num_edges[0]),
                edges_dropped=int(g.edges_dropped[0]),
                full=bool(final.graph_full[0]), quarters=quarters,
                overall=float(np.sqrt((err ** 2).mean())),
                cover=[float(d_cover[i * q:(i + 1) * q].mean())
                       for i in range(4)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-nodes", type=int, required=True)
    ap.add_argument("--macros", type=int, default=128)
    ap.add_argument("--kf-dist", type=float, default=1.0,
                    help="keyframe spacing [m] (shrunk from the reference's "
                         "5 m so the mission overruns capacity)")
    ap.add_argument("--degree-weight", type=float, default=None,
                    help="evict_degree_weight override (0 = the pure "
                         "redundancy policy)")
    ap.add_argument("--protect-recent", type=int, default=None,
                    help="evict_protect_recent override")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = config(args.max_nodes, args.kf_dist, args.degree_weight,
                 args.protect_recent)
    world = world2d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    gen = torch.Generator(device).manual_seed(0)
    st = slam2d.init_state(cfg, 1, device=device, generator=gen,
                           with_graph=True)
    r = run(cfg, world, st, args.macros, gen)
    print(f"max_nodes={args.max_nodes} kf_dist={args.kf_dist} "
          f"degree_weight={cfg.graph.evict_degree_weight} "
          f"steps={r['steps']}: nodes={r['nodes']} edges={r['edges']} "
          f"edges_dropped={r['edges_dropped']} full={r['full']}")
    print("ATE by mission quarter [cm]: "
          + "  ".join(f"Q{i + 1}={s * 100:.2f}"
                      for i, s in enumerate(r["quarters"]))
          + f"  |  overall={r['overall'] * 100:.2f}")
    print("mean dist to nearest surviving node [m]: "
          + "  ".join(f"Q{i + 1}={s:.2f}" for i, s in enumerate(r["cover"])))


if __name__ == "__main__":
    main()
