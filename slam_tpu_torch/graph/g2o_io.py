"""g2o text files for the keyframe pose graph — counterpart of
slam_tpu/graph/g2o_io.py (`save_g2o`, `save_g2o_se3`, `load_g2o`,
`load_g2o_se3`).

The reference optimises its graph with g2o's VertexSE3 / EdgeSE3, whose
exchange format is the g2o text file:

  - save_g2o mode "se3": VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines of the
    planar (x, y, yaw, z) graph: yaw as a z-axis quaternion, the 4 x 4
    information embedded at g2o's (x, y, z, qx, qy, qz) order (x -> 0,
    y -> 1, z -> 2, yaw -> 5), the unobserved roll and pitch rows pinned
    at `rp_info`;
  - save_g2o mode "se2": VERTEX_SE2 / EDGE_SE2 lines (z dropped);
  - save_g2o_se3: the 6-DoF Se3Graph with full rotations and 6 x 6
    information.

The port's graphs are batched over robots, so a save writes one robot's
graph (`robot`) and a load returns a graph of batch 1. Host-side numpy
text I/O: the same %.9g fields in the same line order as slam_tpu, so a
graph saved by either package reads the same in both. Loads pad to the
given capacities and raise on overflow; they put the graph on the card
unless `device` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.graph.pose_graph import init_graph
from slam_tpu_torch.graph.pose_graph3d import (init_se3_graph, quat_to_rot,
                                               rot_to_quat)
from slam_tpu_torch.types import PoseGraph

# (x, y, yaw, z) -> g2o SE3 tangent (x, y, z, roll, pitch, yaw)
_SE3_IDX = np.array([0, 1, 5, 2])


def _yaw_to_quat(yaw):
    h = 0.5 * np.asarray(yaw, np.float64)
    return np.stack([np.zeros_like(h), np.zeros_like(h),
                     np.sin(h), np.cos(h)], -1)     # qx qy qz qw


def _quat_to_yaw(qx, qy, qz, qw):
    return np.arctan2(2.0 * (qw * qz + qx * qy),
                      1.0 - 2.0 * (qy * qy + qz * qz))


def _np(t: torch.Tensor, robot: int, dtype) -> np.ndarray:
    return t[robot].detach().cpu().numpy().astype(dtype)


def _upper(M: np.ndarray) -> list:
    d = M.shape[0]
    return [M[r, c] for r in range(d) for c in range(r, d)]


def _unpack_upper(vals, d: int) -> np.ndarray:
    M = np.zeros((d, d))
    k = 0
    for r in range(d):
        for c in range(r, d):
            M[r, c] = M[c, r] = vals[k]
            k += 1
    return M


def _write(path: str, lines: list) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def save_g2o(path: str, graph: PoseGraph, mode: str = "se3",
             rp_info: float = 1e4, robot: int = 0) -> tuple[int, int]:
    """Write robot `robot`'s valid nodes and edges; returns (n_nodes,
    n_edges). Node ids are slot indices; the first valid node is written
    as FIX, the gauge the optimiser holds."""
    if mode not in ("se3", "se2"):
        raise ValueError(f"mode must be 'se3' or 'se2', got {mode!r}")
    poses = _np(graph.node_pose, robot, np.float64)     # (N, 4) x y yaw z
    nv = _np(graph.node_valid, robot, bool)
    eij = _np(graph.edge_ij, robot, np.int64)
    erel = _np(graph.edge_rel, robot, np.float64)       # (E, 4)
    einfo = _np(graph.edge_info, robot, np.float64)     # (E, 4, 4)
    ev = _np(graph.edge_valid, robot, bool)

    lines = []
    valid_ids = np.flatnonzero(nv)
    for i in valid_ids:
        x, y, yaw, z = poses[i]
        if mode == "se2":
            lines.append(f"VERTEX_SE2 {i} {x:.9g} {y:.9g} {yaw:.9g}")
        else:
            qx, qy, qz, qw = _yaw_to_quat(yaw)
            lines.append(f"VERTEX_SE3:QUAT {i} {x:.9g} {y:.9g} {z:.9g} "
                         f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g}")
    if valid_ids.size:
        lines.append(f"FIX {valid_ids[0]}")
    for e in np.flatnonzero(ev):
        i, j = eij[e]
        dx, dy, dyaw, dz = erel[e]
        if mode == "se2":
            lines.append(f"EDGE_SE2 {i} {j} {dx:.9g} {dy:.9g} {dyaw:.9g} "
                         + " ".join(f"{v:.9g}" for v in
                                    _upper(einfo[e][:3, :3])))
        else:
            qx, qy, qz, qw = _yaw_to_quat(dyaw)
            I6 = np.zeros((6, 6))
            I6[np.ix_(_SE3_IDX, _SE3_IDX)] = einfo[e]
            I6[3, 3] = I6[4, 4] = rp_info
            lines.append(
                f"EDGE_SE3:QUAT {i} {j} {dx:.9g} {dy:.9g} {dz:.9g} "
                f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g} "
                + " ".join(f"{v:.9g}" for v in _upper(I6)))
    _write(path, lines)
    return int(nv.sum()), int(ev.sum())


def save_g2o_se3(path: str, graph, robot: int = 0) -> tuple[int, int]:
    """VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines of robot `robot`'s Se3Graph
    (graph/pose_graph3d.py): full rotations and 6 x 6 information.
    Returns (n_nodes, n_edges)."""
    t = _np(graph.node_t, robot, np.float64)
    q = _np(rot_to_quat(graph.node_R), robot, np.float64)    # [w x y z]
    nv = _np(graph.node_valid, robot, bool)
    eij = _np(graph.edge_ij, robot, np.int64)
    et = _np(graph.edge_t, robot, np.float64)
    eq = _np(rot_to_quat(graph.edge_R), robot, np.float64)
    einfo = _np(graph.edge_info, robot, np.float64)
    ev = _np(graph.edge_valid, robot, bool)

    lines = []
    valid_ids = np.flatnonzero(nv)
    for i in valid_ids:
        w, x, y, z = q[i]
        lines.append(
            f"VERTEX_SE3:QUAT {i} {t[i, 0]:.9g} {t[i, 1]:.9g} {t[i, 2]:.9g} "
            f"{x:.9g} {y:.9g} {z:.9g} {w:.9g}")
    if valid_ids.size:
        lines.append(f"FIX {valid_ids[0]}")
    for e in np.flatnonzero(ev):
        i, j = eij[e]
        w, x, y, z = eq[e]
        lines.append(
            f"EDGE_SE3:QUAT {i} {j} {et[e, 0]:.9g} {et[e, 1]:.9g} "
            f"{et[e, 2]:.9g} {x:.9g} {y:.9g} {z:.9g} {w:.9g} "
            + " ".join(f"{v:.9g}" for v in _upper(einfo[e])))
    _write(path, lines)
    return int(nv.sum()), int(ev.sum())


def _device_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a)[None].to(device)


def load_g2o_se3(path: str, max_nodes: int, max_edges: int, device=None):
    """VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines as an Se3Graph of batch 1
    (full 6-DoF, no planar projection). Raises on capacity overflow."""
    device = default_device(device)
    N, E = max_nodes, max_edges
    node_t = np.zeros((N, 3), np.float32)
    node_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (N, 1))
    node_valid = np.zeros(N, bool)
    edge_ij = np.zeros((E, 2), np.int32)
    edge_t = np.zeros((E, 3), np.float32)
    edge_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (E, 1))
    edge_info = np.zeros((E, 6, 6), np.float32)
    edge_valid = np.zeros(E, bool)
    n_edges = 0

    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0] in ("FIX", "#"):
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                i = int(tok[1])
                if i >= N:
                    raise ValueError(f"vertex id {i} exceeds "
                                     f"max_nodes={N}")
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                node_t[i] = (x, y, z)
                node_q[i] = (qw, qx, qy, qz)
                node_valid[i] = True
            elif tok[0] == "EDGE_SE3:QUAT":
                if n_edges >= E:
                    raise ValueError(f"more than max_edges={E} edges")
                x, y, z, qx, qy, qz, qw = map(float, tok[3:10])
                edge_ij[n_edges] = (int(tok[1]), int(tok[2]))
                edge_t[n_edges] = (x, y, z)
                edge_q[n_edges] = (qw, qx, qy, qz)
                edge_info[n_edges] = _unpack_upper(
                    [float(v) for v in tok[10:31]], 6)
                edge_valid[n_edges] = True
                n_edges += 1

    def dev(a):
        return _device_tensor(a, device)
    return init_se3_graph(1, N, E, device=device).replace(
        node_t=dev(node_t), node_R=quat_to_rot(dev(node_q)),
        node_valid=dev(node_valid), edge_ij=dev(edge_ij),
        edge_t=dev(edge_t), edge_R=quat_to_rot(dev(edge_q)),
        edge_info=dev(edge_info), edge_valid=dev(edge_valid))


def load_g2o(path: str, cfg, device=None) -> PoseGraph:
    """A g2o file's SE2 and SE3:QUAT lines as a PoseGraph of batch 1 sized
    by `cfg` (GraphConfig). Keyframe clouds are empty (g2o files carry no
    points); node stamps follow vertex order, and num_nodes is the highest
    vertex id + 1 (the slot add_keyframe fills next), so optimise and
    add_keyframe work on the result. Raises on capacity overflow, vertex
    ids beyond max_nodes and duplicate vertex ids."""
    device = default_device(device)
    N, E = cfg.max_nodes, cfg.max_edges
    node_pose = np.zeros((N, 4), np.float32)
    node_valid = np.zeros(N, bool)
    node_stamp = -np.ones(N, np.int32)
    edge_ij = np.zeros((E, 2), np.int32)
    edge_rel = np.zeros((E, 4), np.float32)
    edge_info = np.zeros((E, 4, 4), np.float32)
    edge_valid = np.zeros(E, bool)
    n_seen = n_edges = 0
    max_id = -1

    def vertex(idx, pose4):
        nonlocal n_seen, max_id
        if idx >= N:
            raise ValueError(f"vertex id {idx} exceeds max_nodes={N}")
        if node_valid[idx]:
            raise ValueError(f"duplicate vertex id {idx}: {path}")
        node_pose[idx], node_valid[idx] = pose4, True
        node_stamp[idx] = n_seen
        n_seen += 1
        max_id = max(max_id, idx)

    def edge(i, j, rel4, info44):
        nonlocal n_edges
        if n_edges >= E:
            raise ValueError(f"more than max_edges={E} edges in {path}")
        edge_ij[n_edges] = (i, j)
        edge_rel[n_edges] = rel4
        edge_info[n_edges] = info44
        edge_valid[n_edges] = True
        n_edges += 1

    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0] in ("FIX", "#"):
                continue
            tag = tok[0]
            if tag == "VERTEX_SE2":
                i, x, y, th = int(tok[1]), *map(float, tok[2:5])
                vertex(i, (x, y, th, 0.0))
            elif tag == "VERTEX_SE3:QUAT":
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                vertex(int(tok[1]), (x, y, _quat_to_yaw(qx, qy, qz, qw), z))
            elif tag == "EDGE_SE2":
                dx, dy, dth = map(float, tok[3:6])
                I4 = np.zeros((4, 4))
                I4[:3, :3] = _unpack_upper([float(v) for v in tok[6:12]], 3)
                I4[3, 3] = 1.0     # z unobserved in SE2 files
                edge(int(tok[1]), int(tok[2]), (dx, dy, dth, 0.0), I4)
            elif tag == "EDGE_SE3:QUAT":
                dx, dy, dz, qx, qy, qz, qw = map(float, tok[3:10])
                I6 = _unpack_upper([float(v) for v in tok[10:31]], 6)
                edge(int(tok[1]), int(tok[2]),
                     (dx, dy, _quat_to_yaw(qx, qy, qz, qw), dz),
                     I6[np.ix_(_SE3_IDX, _SE3_IDX)])
            # other tags (parameters, other vertex types) are skipped

    def dev(a):
        return _device_tensor(a, device)
    return init_graph(cfg, 1, device).replace(
        node_pose=dev(node_pose), node_valid=dev(node_valid),
        node_stamp=dev(node_stamp), edge_ij=dev(edge_ij),
        edge_rel=dev(edge_rel), edge_info=dev(edge_info),
        edge_valid=dev(edge_valid),
        num_nodes=torch.full((1,), max_id + 1, dtype=torch.int32,
                             device=device),
        num_edges=torch.full((1,), n_edges, dtype=torch.int32,
                             device=device))
