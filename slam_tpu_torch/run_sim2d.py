"""Single-robot 2D SLAM rollout with trajectory and map rendering —
counterpart of examples/run_sim2d.py.

    python3 -m slam_tpu_torch.run_sim2d [--steps 200] [--out /tmp/slam2d]
        [--graph] [--device cpu]

Runs config 1's tick for one robot (kernel K1 on the card), or with
--graph the pose-graph pipeline (config 4's: K2 on the keyframe edges, K4
on their information) in macros of 8 ticks and a graph tick, the steps
rounded up to whole macros. Prints the ATE after the first 12 ticks and
the map's size, and renders the trajectory and the drivability grid. On
the card unless given --device cpu; it raises without one.
"""

from __future__ import annotations

import argparse
import os

import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.sim import world2d


def run(cfg, world, state, steps: int, generator: torch.Generator,
        graph: bool = False) -> dict:
    """Roll `state` (batch 1; with a pose graph for graph=True) through
    `steps` ticks of `world`, the sensor noise drawn from `generator`.
    Returns the printed numbers (steps, ate, map_points, and keyframes and
    edges with graph) and the run itself (final, est, true: robot 0's
    trajectories (T, 3))."""
    if graph:
        # round up like the rollouts themselves: flooring would truncate
        # non-multiples of 8 and give an empty run below 8
        final, (est, true) = slam2d.rollout_with_graph(
            state, world, cfg, -(-steps // 8), generator, graph_every=8)
    else:
        final, (est, true) = slam2d.rollout(state, world, cfg, steps,
                                            generator)
    est, true = est[0], true[0]
    out = dict(steps=est.shape[0], ate=float(slam2d.ate(est[12:], true[12:])),
               map_points=int(final.map_cloud.valid[0].sum()),
               final=final, est=est, true=true)
    if graph:
        out.update(keyframes=int(final.graph.num_nodes[0]),
                   edges=int(final.graph.num_edges[0]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="/tmp/slam2d")
    ap.add_argument("--graph", action="store_true",
                    help="run the full pose-graph pipeline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from slam_tpu_torch.utils import viz

    device = default_device(args.device)
    cfg = sim2d_config()
    world = world2d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    gen = torch.Generator(device).manual_seed(0)
    state = slam2d.init_state(cfg, 1, device=device, generator=gen,
                              with_graph=args.graph)
    r = run(cfg, world, state, args.steps, gen, graph=args.graph)
    print(f"steps={r['steps']}  ATE={r['ate']:.4f} m  "
          f"map_points={r['map_points']}")
    if args.graph:
        print(f"keyframes={r['keyframes']}  edges={r['edges']}")

    os.makedirs(args.out, exist_ok=True)
    final = r["final"]
    mp = final.map_cloud.xyz[0][final.map_cloud.valid[0]]
    viz.render_trajectory(os.path.join(args.out, "trajectory.png"),
                          r["est"], r["true"], mp)
    viz.render_grid(os.path.join(args.out, "drivability.png"),
                    final.local_map.drivable[0],
                    title="drivability (rolling local map)")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
