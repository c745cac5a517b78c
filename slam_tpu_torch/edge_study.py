"""The keyframe edges of config 4 in 3D against ground truth, on the card:
slam3d.rollout_3d_with_graph at sim3d_se3_config for 128 robots (as
chip_smoke.py's [se3] phase runs it: world seed 42, the fleet from
`--seeds`), with 3D ICP edges and with planar edges. For each run it
prints each robot's farthest keyframe from its true path (quantiles, the
robots beyond 0.8 m) and each stored edge's planar measurement (x, y,
yaw, z in the from-node's frame) against the true relative pose of its
two keyframes, and for the worst robot of the first seed its nodes and
edges. With `--dump`, the edge problems of that robot whose measurement
lies more than 0.5 m from the truth go to an .npz (the fit's inputs, the
card's result and the truth), which tests/test_torch_icp3d.py replays
through slam_tpu's icp3d_fit and the port's on the CPU.

    python3 -m slam_tpu_torch.edge_study --seeds 18 19 20 --dump se3_edge_minima.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess

import numpy as np
import torch

from slam_tpu_torch.config import sim3d_se3_config
from slam_tpu_torch.graph import pose_graph as pg
from slam_tpu_torch.pipeline import slam2d, slam3d
from slam_tpu_torch.sim import world3d

FLEET = 128
MACROS = 6           # of 8 ticks and a graph tick, as [se3]'s 3D-edge run
NODE_LIMIT = 0.8     # m, slam_tpu's test bound on a keyframe's offset
DUMP_ERR = 0.5       # m, an edge this far from the truth is dumped


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def run(cfg, world, edges: str, seed: int, gen, dev, record: bool):
    """One fleet run. Returns the final graph, the trajectories, each
    node's true pose at insertion (B, N, 4), each edge's true relative
    pose (B, E, 4) and, with `record`, every graph tick's edge fits
    (inputs and results on the host) and new nodes."""
    c = cfg.replace(graph=dataclasses.replace(cfg.graph,
                                              edge_registration=edges))
    s = slam3d.init_state_3d(c, FLEET, world, device=dev,
                             generator=gen.manual_seed(seed),
                             with_graph=True)
    gm = slam3d.init_ground_map(c, FLEET, dev)
    N = c.graph.max_nodes
    node_true = torch.full((FLEET, N, 4), float("nan"), device=dev)
    ticks, fits = [], []
    update, fit = slam3d.graph_update_delta, pg.icp3d_fit

    def tick(st, cc):
        before = st.graph.node_stamp.clone()
        out = update(st, cc)
        g = out[0].graph
        new = (g.node_stamp != before) & g.node_valid
        node_true[new] = st.true_pose[:, None].expand(-1, N, -1)[new]
        ticks.append(new.cpu())
        return out

    def kept_fit(*a, **k):
        res = fit(*a, **k)
        fits.append(dict(args=[x.cpu() for x in a[:8]],
                         max_iterations=k.get("max_iterations"),
                         t=res.t.cpu(), R=res.R.cpu()))
        return res

    slam3d.graph_update_delta = tick
    if record:
        pg.icp3d_fit = kept_fit
    try:
        s, _, (est, true) = slam3d.rollout_3d_with_graph(
            s, world, gm, c, MACROS, gen, 8)
    finally:
        slam3d.graph_update_delta, pg.icp3d_fit = update, fit
    g = s.graph
    rows = torch.arange(FLEET, device=dev)[:, None]
    ti = node_true[rows, g.edge_ij[..., 0].long()]
    tj = node_true[rows, g.edge_ij[..., 1].long()]
    d = tj - ti
    cth, sth = torch.cos(ti[..., 2]), torch.sin(ti[..., 2])
    rel_true = torch.stack([cth * d[..., 0] + sth * d[..., 1],
                            -sth * d[..., 0] + cth * d[..., 1],
                            _wrap(d[..., 2]), d[..., 3]], -1)
    return g, est, true, node_true, rel_true, ticks, fits


def report(edges, seed, g, est, true, rel_true):
    """Print one run's line; returns each robot's farthest node from its
    true path (B,) and each edge's xy error (B, E)."""
    ate = slam2d.ate(est[:, 8:], true[:, 8:])
    d = torch.cdist(g.node_pose[..., :2], true[..., :2]).amin(-1)
    node_off = torch.where(g.node_valid, d, 0.0).amax(-1)
    err = g.edge_rel - rel_true
    e_xy = torch.where(g.edge_valid,
                       torch.linalg.vector_norm(err[..., :2], dim=-1), 0.0)
    v = g.edge_valid
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], device=est.device)
    fmt = lambda x: ", ".join(f"{float(y):.4f}" for y in x)  # noqa: E731
    print(f"{edges} edges, seed {seed}: median ATE {float(ate.median()):.4f}"
          f" m; each robot's farthest node from its true path, quantiles "
          f"0.5/0.9/0.99/1: {fmt(torch.quantile(node_off, q))} m, robots "
          f"beyond {NODE_LIMIT} m: {int((node_off > NODE_LIMIT).sum())}; "
          f"{int(v.sum())} edges, xy error quantiles "
          f"{fmt(torch.quantile(e_xy[v], q))} m, beyond 0.3 m: "
          f"{int((e_xy > 0.3).sum())}, beyond {DUMP_ERR} m: "
          f"{int((e_xy > DUMP_ERR).sum())}, max |yaw error| "
          f"{float(_wrap(err[..., 2]).abs()[v].max()):.4f} rad, max |z "
          f"error| {float(err[..., 3].abs()[v].max()):.4f} m", flush=True)
    return node_off, e_xy


def worst_robot(r, g, node_true, rel_true, e_xy):
    """Print robot r's nodes and edges against the truth."""
    for k in torch.nonzero(g.node_valid[r])[:, 0].tolist():
        print(f"  robot {r} node {k}: pose {g.node_pose[r, k].tolist()}, "
              f"true at insertion {node_true[r, k].tolist()}")
    for e in torch.nonzero(g.edge_valid[r])[:, 0].tolist():
        print(f"  robot {r} edge {g.edge_ij[r, e].tolist()}: measured "
              f"{g.edge_rel[r, e].tolist()}, true {rel_true[r, e].tolist()}"
              f", xy error {float(e_xy[r, e]):.4f} m", flush=True)


def dump(path, r, g, rel_true, e_xy, ticks, fits, K):
    """robot r's edges beyond DUMP_ERR: the fit whose result the edge
    stored, found at the graph tick that inserted its to-node."""
    out = {k: [] for k in ("scene_xyz", "scene_valid", "scene_class",
                           "model_xyz", "model_valid", "model_class",
                           "init_t", "init_R", "card_t", "card_R",
                           "true_rel")}
    for e in torch.nonzero(e_xy[r] > DUMP_ERR)[:, 0].tolist():
        j = int(g.edge_ij[r, e, 1])
        at = next(n for n, new in enumerate(ticks) if bool(new[r, j]))
        f = fits[at]
        t6 = g.edge_rel6[r, e, :3].cpu()
        p = min(range(r * K, (r + 1) * K),
                key=lambda i: float((f["t"][i] - t6).abs().max()))
        for key, x in zip(list(out)[:8], f["args"]):
            out[key].append(x[p].numpy())
        out["card_t"].append(f["t"][p].numpy())
        out["card_R"].append(f["R"][p].numpy())
        out["true_rel"].append(rel_true[r, e].cpu().numpy())
    np.savez_compressed(path, max_iterations=fits[0]["max_iterations"],
                        **{k: np.stack(v) for k, v in out.items()})
    print(f"dumped {len(out['init_t'])} edge problems of robot {r} to "
          f"{path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[18])
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("edge_study needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    cfg = sim3d_se3_config()
    world = world3d.make_world(gen.manual_seed(42), cfg.sim, device=dev)
    for n, seed in enumerate(args.seeds):
        for edges in ("3d", "2d"):
            first = n == 0 and edges == "3d"
            g, est, true, node_true, rel_true, ticks, fits = run(
                cfg, world, edges, seed, gen, dev, first and bool(args.dump))
            node_off, e_xy = report(edges, seed, g, est, true, rel_true)
            if first:
                r = int(node_off.argmax())
                worst_robot(r, g, node_true, rel_true, e_xy)
                if args.dump:
                    dump(args.dump, r, g, rel_true, e_xy, ticks, fits,
                         1 + cfg.graph.knn_edges)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
