"""Keyframe pose-graph SLAM — counterpart of slam_tpu/graph/pose_graph.py
(`init_graph`, `nearest_kf_dist`, `knn_keyframes`, `newest_node`,
`_eviction_slot`, `add_keyframe`, `_edge_measurement`,
`_edge_measurement_3d`, `_se2_edge_residuals`, `optimize`,
`relocalization_edge`, `_kf_world_xyz`, `regenerate_map`,
`regenerate_map_mls`, `regenerate_map_grid`, `home_command`,
`mission_command`), batched over robots.

A robot's graph has fixed capacity: N keyframe slots, E edge slots. A
keyframe is gated by distance to the nearest one (5 m), evicts the most
redundant old keyframe when the graph is full, and gets edges to the
previous keyframe and to its k nearest. With planar edges
(edge_registration "2d") each edge is measured by fused ICP between the
two keyframe clouds, with the 2D Censi / LUM information over the final
correspondences; then a dense Gauss-Newton / LM solve over (x, y, yaw)
and a linear z solve optimise the graph (engine "se2z"; engine "se3" is
graph/pose_graph3d.optimize_planar), and the scan-to-map target is
regenerated from the keyframes under their optimised poses.

The 6-DoF graph (edge_registration "3d", engine "se3") keeps each
keyframe in its capture body frame (tilted back by the measured roll and
pitch, which node_rp holds), measures edges by 3D ICP (ops/icp3d.py) from
the SE(3) relative odometry with the 6 x 6 LUM information
(edge_rel6, edge_info6, and their planar projection in edge_rel and
edge_info), and is optimised by pose_graph3d.optimize_native.

Where slam_tpu branches per robot (`lax.cond` under `vmap`, which runs
both branches and selects), this module runs the whole batch and selects
with `torch.where`; nothing reads a device value from Python, so a graph
tick never waits for the card. On the card every candidate planar edge
of every robot goes through kernel K2 (`ops/icp_fused.icp_fused`) in one
call (K3 above RESIDENT_TILE_LIMIT), and the information's nearest
neighbours through K4; CPU tensors take their plain versions. The 3D
edges are plain PyTorch, all B x (1 + knn_edges) problems in one batched
fit. The target is regenerated by one of three engines: a voxel merge of
every keyframe ("voxel"), a global MLS rebuild exported as cluster means
("mls", a Python loop of one batched `add_to_mls` per keyframe slot) or
a centroid grid around the newest node ("grid").
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from slam_tpu_torch import default_device, true_div
from slam_tpu_torch.geometry import (angle_wrap, rot3_from_rpy,
                                     se2_apply_xy, se2_compose, se2_relative)
from slam_tpu_torch.graph.pose_graph3d import (edge_information_lum6,
                                               embed_planar_info,
                                               pin_roll_pitch, planar_info,
                                               so3_log)
from slam_tpu_torch.mapping.mls import (add_to_mls, get_segmented_clouds,
                                        init_mls)
from slam_tpu_torch.mapping.point_map import (export_points, init_point_map,
                                              update_point_map_xy)
from slam_tpu_torch.ops.icp import edge_information_2d
from slam_tpu_torch.ops.icp3d import icp3d_fit
from slam_tpu_torch.ops.icp_fused import icp_fused
from slam_tpu_torch.ops.linalg import cho_solve
from slam_tpu_torch.ops.nn import nearest_neighbor
from slam_tpu_torch.ops.scatter2d import index_add
from slam_tpu_torch.ops.voxel import compact, voxel_downsample
from slam_tpu_torch.types import PointCloud, PoseGraph
from slam_tpu_torch.utils.profiling import stage


def init_graph(cfg, batch: int, device=None,
               dtype=torch.float32) -> PoseGraph:
    """Empty graphs for a batch of robots, on the card unless `device`
    says otherwise; with edge_registration "3d" the 6-DoF fields too,
    which only engine "se3" consumes."""
    full3d = cfg.edge_registration == "3d"
    if full3d and cfg.engine != "se3":
        raise ValueError(
            'edge_registration="3d" produces SE(3) measurements only the '
            '"se3" engine consumes; set GraphConfig.engine="se3"')
    device = default_device(device)
    N, E, P = cfg.max_nodes, cfg.max_edges, cfg.keyframe_points

    def z(*shape, dt=dtype):
        return torch.zeros((batch,) + shape, dtype=dt, device=device)
    return PoseGraph(
        node_pose=z(N, 4), node_valid=z(N, dt=torch.bool),
        node_stamp=torch.full((batch, N), -1, dtype=torch.int32,
                              device=device),
        kf_xyz=z(N, P, 3), kf_valid=z(N, P, dt=torch.bool),
        kf_flags=z(N, P, dt=torch.int32), edge_ij=z(E, 2, dt=torch.int32),
        edge_rel=z(E, 4), edge_info=z(E, 4, 4),
        edge_valid=z(E, dt=torch.bool), num_nodes=z(dt=torch.int32),
        num_edges=z(dt=torch.int32), edges_dropped=z(dt=torch.int32),
        node_rp=z(N, 2) if full3d else None,
        edge_rel6=z(E, 6) if full3d else None,
        edge_info6=z(E, 6, 6) if full3d else None)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _node_dist(graph: PoseGraph, pose_xy: torch.Tensor) -> torch.Tensor:
    """(B, N) planar distance of each valid node to pose_xy (B, 2), inf for
    invalid nodes."""
    d = graph.node_pose[..., :2] - pose_xy[:, None, :]
    d = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    return torch.where(graph.node_valid, d, float("inf"))


def nearest_kf_dist(graph: PoseGraph, pose_xy: torch.Tensor) -> torch.Tensor:
    """(B,) distance to the nearest keyframe; inf for an empty graph."""
    return _node_dist(graph, pose_xy).amin(-1)


def knn_keyframes(graph: PoseGraph, pose_xy: torch.Tensor, k: int,
                  exclude: torch.Tensor):
    """(idx (B, k), ok (B, k)): the k nearest keyframes to pose_xy (B, 2),
    leaving out node `exclude` (B,). Ties go to the lower index, as
    jax.lax.top_k orders them (invalid nodes tie at inf): a stable sort
    fixes that order, which torch.topk leaves open."""
    d = _node_dist(graph, pose_xy)
    N = d.shape[-1]
    d = torch.where(torch.arange(N, device=d.device) == exclude[:, None],
                    float("inf"), d)
    kk = min(k, N)
    vals, idx = torch.sort(d, dim=-1, stable=True)
    idx, ok = idx[:, :kk], torch.isfinite(vals[:, :kk])
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk))
        ok = torch.nn.functional.pad(ok, (0, k - kk))
    return idx, ok


def newest_node(graph: PoseGraph):
    """(index (B,), exists (B,)) of the most recently inserted valid node
    (the first slot of the largest stamp)."""
    stamp = torch.where(graph.node_valid, graph.node_stamp, -1)
    return stamp.argmax(-1), stamp.amax(-1) >= 0


def _eviction_slot(graph: PoseGraph, degree_weight: float = 0.5,
                   protect_recent: int = 1):
    """(slot (B,), evictable (B,)): the valid node with the least
    distance to another keyframe plus degree_weight per incident edge,
    never node 0 (the gauge anchor) nor the protect_recent newest; the
    first such slot on ties."""
    xy = graph.node_pose[..., :2]
    N = xy.shape[1]
    diff = xy[:, :, None, :] - xy[:, None, :, :]
    d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    ar = torch.arange(N, device=xy.device)
    pair_ok = graph.node_valid[:, :, None] & graph.node_valid[:, None, :] & \
        (ar[:, None] != ar[None, :])
    dmin = torch.where(pair_ok, d, float("inf")).amin(-1)
    ev = graph.edge_valid.to(xy.dtype)
    degree = torch.zeros_like(dmin)
    degree.scatter_add_(1, graph.edge_ij[..., 0].long(), ev)
    degree.scatter_add_(1, graph.edge_ij[..., 1].long(), ev)
    k = max(1, int(protect_recent))
    recent = graph.node_stamp > (graph.node_stamp.amax(-1, keepdim=True) - k)
    score = torch.where(graph.node_valid & (ar != 0) & ~recent,
                        dmin + degree_weight * degree, float("inf"))
    return score.argmin(-1), torch.isfinite(score.amin(-1))


def _edge_information(pose, s_xy, s_valid, m_xy, m_valid, max_corr):
    """LUM information (n, 3, 3) of n registered problems over the final
    correspondences: each valid scene point under `pose` (n, 3) and its
    nearest model point (unconstrained), if nearer than max_corr. Returns
    (information, the correspondences' 0/1 weights (n, S))."""
    qx, qy = se2_apply_xy(pose, s_xy[..., 0], s_xy[..., 1])
    q = torch.stack([qx, qy], -1)
    idx, d2 = nearest_neighbor(q, m_xy, m_valid)
    w = (s_valid & (d2 < max_corr ** 2)).to(q.dtype)
    m_corr = torch.gather(m_xy, 1, idx.long()[..., None].expand_as(q))
    return edge_information_2d(q, m_corr, w), w


def _edge_measurement(graph: PoseGraph, src: torch.Tensor, dst: torch.Tensor,
                      icp_cfg, gcfg):
    """Edges src (B, K) -> dst (B,): register node dst's keyframe cloud
    (the scene) against each node src's (the model), both in their node
    frames, from the relative odometry pose, in ONE fused-ICP call over all
    B x K problems at the graph's ICP budget (edge_icp_max_iter); then the
    LUM information over the final correspondences within edge_max_corr,
    and the rejection gates (translation per axis, rotation, overlap).
    Returns (rel (B, K, 4), info (B, K, 4, 4), ok (B, K))."""
    B, K = src.shape
    P = graph.kf_xyz.shape[2]
    rows = _rows(src)
    pi = graph.node_pose[rows[:, None], src]                    # (B, K, 4)
    pj = graph.node_pose[rows, dst][:, None].expand(B, K, 4)
    init_rel = se2_relative(pi[..., :3], pj[..., :3]).reshape(B * K, 3)
    icp_cfg = dataclasses.replace(icp_cfg,
                                  max_iterations=gcfg.edge_icp_max_iter)

    def cloud(at):           # (B, K', P, ...) of the nodes `at` (B, K')
        xy = graph.kf_xyz[rows[:, None], at][..., :2]
        valid = graph.kf_valid[rows[:, None], at]
        ga = (graph.kf_flags[rows[:, None], at] & PointCloud.FLAG_GA) != 0
        return (xy.expand(B, K, P, 2).reshape(B * K, P, 2),
                valid.expand(B, K, P).reshape(B * K, P),
                ga.expand(B, K, P).reshape(B * K, P))
    s_xy, s_valid, s_ga = cloud(dst[:, None])
    m_xy, m_valid, m_ga = cloud(src)
    with stage("graph.edge_icp"):
        res = icp_fused(s_xy, s_valid, s_ga, m_xy, m_valid, m_ga, init_rel,
                        icp_cfg)
    with stage("graph.edge_information"):
        info3, w = _edge_information(res.pose, s_xy, s_valid, m_xy, m_valid,
                                     gcfg.edge_max_corr)

    x_diff = (init_rel[:, 0] - res.pose[:, 0]).abs()
    y_diff = (init_rel[:, 1] - res.pose[:, 1]).abs()
    t_diff = angle_wrap(init_rel[:, 2] - res.pose[:, 2]).abs()
    ok = res.ok & (x_diff <= gcfg.dist_move_thresh) & \
        (y_diff <= gcfg.dist_move_thresh) & \
        (t_diff <= gcfg.rot_move_thresh) & (w.sum(-1) >= gcfg.edge_min_corr)

    rel = torch.cat([res.pose, (pj[..., 3] - pi[..., 3]).reshape(B * K, 1)],
                    -1)
    info4 = torch.zeros(B * K, 4, 4, dtype=info3.dtype, device=info3.device)
    info4[:, :3, :3] = info3
    info4[:, 3, 3] = 1.0
    return rel.view(B, K, 4), info4.view(B, K, 4, 4), ok.view(B, K)


def _point_class(flags: torch.Tensor) -> torch.Tensor:
    """3D edge classes: 0 obstacle, 1 ground-adjacent obstacle, 2 ground
    (the ground points of 6-DoF keyframes are what constrain z)."""
    ga = (flags & PointCloud.FLAG_GA) != 0
    gnd = (flags & PointCloud.FLAG_GROUND) != 0
    return torch.where(gnd, 2, torch.where(ga, 1, 0)).to(torch.int32)


def _edge_measurement_3d(graph: PoseGraph, src: torch.Tensor,
                         dst: torch.Tensor, icp_cfg, gcfg):
    """6-DoF edges src (B, K) -> dst (B,): register node dst's keyframe
    cloud (the scene, body frame) against each node src's by 3D ICP from
    the SE(3) relative odometry (Ri^T Rj, Ri^T (tj - ti)), all B x K
    problems in one batched fit at edge_icp_max_iter; the 6 x 6 LUM
    information over the final correspondences within edge_max_corr; the
    gates: each translation axis's move from the odometry, the rotation
    angle's move, the overlap. Returns (rel (B, K, 4), info (B, K, 4, 4)
    the planar projection, rel6 (B, K, 6) [t; rotation vector], info6
    (B, K, 6, 6), ok (B, K))."""
    B, K = src.shape
    P = graph.kf_xyz.shape[2]
    rows = _rows(src)
    pi = graph.node_pose[rows[:, None], src]                    # (B, K, 4)
    pj = graph.node_pose[rows, dst][:, None].expand(B, K, 4)
    rpi = graph.node_rp[rows[:, None], src]
    rpj = graph.node_rp[rows, dst][:, None].expand(B, K, 2)
    Ri = rot3_from_rpy(rpi[..., 0], rpi[..., 1], pi[..., 2])
    Rj = rot3_from_rpy(rpj[..., 0], rpj[..., 1], pj[..., 2])
    ti = torch.stack([pi[..., 0], pi[..., 1], pi[..., 3]], -1)
    tj = torch.stack([pj[..., 0], pj[..., 1], pj[..., 3]], -1)
    init_R = (Ri.mT @ Rj).reshape(B * K, 3, 3)
    init_t = (Ri.mT @ (tj - ti)[..., None])[..., 0].reshape(B * K, 3)

    def cloud(at):           # (B * K, P, ...) of the nodes `at` (B, K')
        xyz = graph.kf_xyz[rows[:, None], at]
        valid = graph.kf_valid[rows[:, None], at]
        cls = _point_class(graph.kf_flags[rows[:, None], at])
        return (xyz.expand(B, K, P, 3).reshape(B * K, P, 3),
                valid.expand(B, K, P).reshape(B * K, P),
                cls.expand(B, K, P).reshape(B * K, P))
    s_xyz, s_valid, s_cls = cloud(dst[:, None])
    m_xyz, m_valid, m_cls = cloud(src)
    res = icp3d_fit(s_xyz, s_valid, s_cls, m_xyz, m_valid, m_cls, init_t,
                    init_R, icp_cfg, max_iterations=gcfg.edge_icp_max_iter)

    q = s_xyz @ res.R.mT + res.t[:, None, :]
    idx, d2 = nearest_neighbor(q, m_xyz, m_valid)
    w = (s_valid & (d2 < gcfg.edge_max_corr ** 2)).to(q.dtype)
    info6 = edge_information_lum6(
        q, torch.gather(m_xyz, 1, idx.long()[..., None].expand_as(q)), w)

    t_move = (res.t - init_t).abs()
    w_move = so3_log(init_R.mT @ res.R)
    ok = res.ok & (t_move <= gcfg.dist_move_thresh).all(-1) & \
        (torch.linalg.vector_norm(w_move, dim=-1) <= gcfg.rot_move_thresh) & \
        (w.sum(-1) >= gcfg.edge_min_corr)
    rel6 = torch.cat([res.t, so3_log(res.R)], -1)
    yaw = torch.atan2(res.R[:, 1, 0], res.R[:, 0, 0])
    rel = torch.stack([res.t[:, 0], res.t[:, 1], yaw, res.t[:, 2]], -1)
    return (rel.view(B, K, 4), planar_info(info6).view(B, K, 4, 4),
            rel6.view(B, K, 6), info6.view(B, K, 6, 6), ok.view(B, K))


def _put(old: torch.Tensor, at: torch.Tensor, new: torch.Tensor):
    """old (B, M, ...) with new (B, ...) written where at (B, M)."""
    m = at.view(at.shape + (1,) * (old.dim() - 2))
    return torch.where(m, new[:, None].to(old.dtype), old)


def _add_edge(g: PoseGraph, src, dst, ok, rel, info, rel6=None,
              info6=None) -> PoseGraph:
    """Store edge src -> dst (B,) where ok, in each robot's first free edge
    slot (with its 6-DoF measurement when the graph has those fields); an
    accepted edge that finds no slot is counted in edges_dropped."""
    e = g.edge_valid.to(torch.int32).argmin(-1)
    room = ~g.edge_valid[_rows(e), e]
    do = ok & room
    at = (torch.arange(g.edge_valid.shape[1], device=e.device) == e[:, None]
          ) & do[:, None]
    valid = g.edge_valid | at
    if g.edge_rel6 is not None:
        g = g.replace(edge_rel6=_put(g.edge_rel6, at, rel6),
                      edge_info6=_put(g.edge_info6, at, info6))
    return g.replace(
        edge_ij=_put(g.edge_ij, at, torch.stack([src, dst], -1)),
        edge_rel=_put(g.edge_rel, at, rel),
        edge_info=_put(g.edge_info, at, info), edge_valid=valid,
        num_edges=valid.sum(-1).to(torch.int32),
        edges_dropped=g.edges_dropped + (ok & ~room).to(torch.int32))


def _make_edges(g: PoseGraph, slot, pose, icp_cfg, cfg) -> PoseGraph:
    """Edges into the new node `slot` from the previous (most recent other)
    node and its knn_edges nearest, each stored if its measurement is
    accepted, in that order."""
    N = g.node_valid.shape[1]
    other = torch.where(g.node_valid & (torch.arange(N, device=slot.device)
                                        != slot[:, None]),
                        g.node_stamp, -1)
    prev, prev_ok = other.argmax(-1), other.amax(-1) >= 0
    knn_idx, knn_ok = knn_keyframes(g, pose[:, :2], cfg.knn_edges, slot)
    cand = torch.cat([prev[:, None], knn_idx], -1)
    cand_ok = torch.cat([prev_ok[:, None], knn_ok & (knn_idx != prev[:, None])],
                        -1)
    if g.node_rp is not None:
        rels, infos, rel6s, info6s, icp_oks = _edge_measurement_3d(
            g, cand, slot, icp_cfg, cfg)
    else:
        rels, infos, icp_oks = _edge_measurement(g, cand, slot, icp_cfg, cfg)
        rel6s = info6s = None
    for c in range(cand.shape[1]):
        g = _add_edge(g, cand[:, c], slot, cand_ok[:, c] & icp_oks[:, c],
                      rels[:, c], infos[:, c],
                      None if rel6s is None else rel6s[:, c],
                      None if info6s is None else info6s[:, c])
    return g


_EDGE_FIELDS = ("edge_ij", "edge_rel", "edge_info", "edge_valid",
                "num_edges", "edges_dropped", "edge_rel6", "edge_info6")


def add_keyframe(graph: PoseGraph, pose: torch.Tensor, cloud: PointCloud,
                 icp_cfg, cfg, min_points: int | None = None,
                 attitude: torch.Tensor | None = None):
    """Gate and insert a keyframe per robot, with its edges. pose (B, 4)
    x, y, yaw, z; cloud: the segmented scene in the robot frame (B, M).
    Returns (graph, added (B,)).

    attitude (B, 2): the measured IMU roll and pitch at capture (zeros
    when None), read only by a 6-DoF graph: the keyframe is stored tilted
    back into the capture body frame, p_body = R_rp^T p_up, so that 3D
    edge registration observes relative attitude, and node_rp takes it.

    A robot adds a keyframe when it is farther than knn_dist_thresh from
    every keyframe (or has none) and the cloud holds >= min_points points.
    A full graph evicts the slot _eviction_slot picks, with its edges; a
    robot whose graph is full and has nothing to evict adds nothing. Edges
    are measured for every robot and kept for those that added a keyframe
    to a non-empty graph."""
    min_points = min_points or 0
    N = graph.node_valid.shape[1]
    far = nearest_kf_dist(graph, pose[:, :2]) > cfg.knn_dist_thresh
    n = graph.num_nodes
    first = n == 0
    has_room = n < cfg.max_nodes
    want = (far | first) & (cloud.valid.sum(-1) >= min_points)
    evict_slot, evictable = _eviction_slot(graph, cfg.evict_degree_weight,
                                           cfg.evict_protect_recent)
    add = want & (has_room | evictable)
    evicting = add & ~has_room
    slot = torch.where(has_room, torch.clamp(n, max=cfg.max_nodes - 1).long(),
                       evict_slot)

    ij = graph.edge_ij
    dead = evicting[:, None] & ((ij[..., 0] == slot[:, None]) |
                                (ij[..., 1] == slot[:, None]))
    edge_valid = graph.edge_valid & ~dead
    packed = compact(cloud, cfg.keyframe_points)
    kf_xyz = packed.xyz
    full3d = graph.node_rp is not None
    if full3d:
        if attitude is None:
            attitude = torch.zeros_like(pose[:, :2])
        kf_xyz = kf_xyz @ rot3_from_rpy(attitude[:, 0], attitude[:, 1],
                                        torch.zeros_like(attitude[:, 0]))
    stamp = graph.node_stamp.amax(-1) + 1
    at = (torch.arange(N, device=slot.device) == slot[:, None]) & add[:, None]
    if full3d:
        graph = graph.replace(node_rp=_put(graph.node_rp, at, attitude))
    new = graph.replace(
        node_pose=_put(graph.node_pose, at, pose),
        node_valid=graph.node_valid | at,
        node_stamp=_put(graph.node_stamp, at, stamp),
        kf_xyz=_put(graph.kf_xyz, at, kf_xyz),
        kf_valid=_put(graph.kf_valid, at, packed.valid),
        kf_flags=_put(graph.kf_flags, at, packed.flags),
        edge_valid=edge_valid,
        num_edges=edge_valid.sum(-1).to(torch.int32),
        num_nodes=torch.where(add & has_room, n + 1, n))
    with_edges = _make_edges(new, slot, pose, icp_cfg, cfg)
    keep = add & ~first
    return new.replace(**{
        f: torch.where(keep.view((-1,) + (1,) * (getattr(new, f).dim() - 1)),
                       getattr(with_edges, f), getattr(new, f))
        for f in _EDGE_FIELDS if getattr(new, f) is not None}), add


def _se2_edge_residuals(poses: torch.Tensor, graph: PoseGraph):
    """Residuals e (B, E, 3) and Jacobian blocks A = de/dx_i, B = de/dx_j
    (B, E, 3, 3) of every edge:
    e_ij = [Rz^T (Ri^T (t_j - t_i) - z_t); wrap(th_j - th_i - z_th)]."""
    rows = _rows(poses)[:, None]
    pi = poses[rows, graph.edge_ij[..., 0].long()]
    pj = poses[rows, graph.edge_ij[..., 1].long()]
    z = graph.edge_rel
    ci, si = torch.cos(pi[..., 2]), torch.sin(pi[..., 2])
    dtx = pj[..., 0] - pi[..., 0]
    dty = pj[..., 1] - pi[..., 1]
    lx = ci * dtx + si * dty
    ly = -si * dtx + ci * dty
    cz, sz = torch.cos(z[..., 2]), torch.sin(z[..., 2])
    ex = cz * (lx - z[..., 0]) + sz * (ly - z[..., 1])
    ey = -sz * (lx - z[..., 0]) + cz * (ly - z[..., 1])
    eth = angle_wrap(pj[..., 2] - pi[..., 2] - z[..., 2])
    e = torch.stack([ex, ey, eth], -1)

    dlx = -si * dtx + ci * dty
    dly = -ci * dtx - si * dty

    def mat2(a, b, c, d):
        return torch.stack([torch.stack([a, b], -1),
                            torch.stack([c, d], -1)], -2)
    Rz_T = mat2(cz, sz, -sz, cz)
    B_tt = Rz_T @ mat2(ci, si, -si, ci)
    A_tth = (Rz_T @ torch.stack([dlx, dly], -1)[..., None])[..., 0]
    zero = torch.zeros_like(ci)
    one = torch.ones_like(ci)
    A = torch.cat([torch.cat([-B_tt, A_tth[..., None]], -1),
                   torch.stack([zero, zero, -one], -1)[..., None, :]], -2)
    Bj = torch.cat([torch.cat([B_tt, zero[..., None, None].expand(
        *zero.shape, 2, 1)], -1),
        torch.stack([zero, zero, one], -1)[..., None, :]], -2)
    return e, A, Bj


def optimize(graph: PoseGraph, cfg, deterministic: bool = False):
    """Dense Gauss-Newton / LM over every robot's (x, y, yaw), then one
    linear least-squares solve of z. Returns (graph with optimised valid
    nodes, delta (B, 4)): the newest node's pose change, yaw wrapped.

    Node 0 holds a 1e5 prior (the gauge), every node lm_lambda damping and
    every invalid node a unit regulariser. The normal matrix is assembled
    with index_add_ into (B, N*N, 3, 3) blocks, so its cost grows with E,
    not with E x N. With opt_min_delta > 0 each robot freezes once its
    largest valid-node update falls below it (that update applied), as
    slam_tpu's while loop under vmap does; all opt_iterations steps run
    for the batch, so no step waits for the card. `deterministic`: the
    normal equations summed the same on every run (scatter2d.index_add),
    for graphs that several ranks hold alike."""
    Bn, N = graph.node_valid.shape
    dev, dt = graph.node_pose.device, graph.node_pose.dtype
    rows = torch.arange(Bn, device=dev)[:, None]
    i = graph.edge_ij[..., 0].long()
    j = graph.edge_ij[..., 1].long()
    w_edge = graph.edge_valid.to(dt)
    Om = graph.edge_info[..., :3, :3] * w_edge[..., None, None]
    last, _ = newest_node(graph)
    pre_last = graph.node_pose[rows[:, 0], last]

    base = rows * N
    blocks = torch.cat([(base + i) * N + i, (base + i) * N + j,
                        (base + j) * N + i, (base + j) * N + j], 1).reshape(-1)
    ends = torch.cat([base + i, base + j], 1).reshape(-1)
    invalid = (~graph.node_valid).to(dt)
    diag = torch.full((Bn, N, 3), cfg.lm_lambda, dtype=dt, device=dev)
    diag[:, 0] = 1e5
    diag = (diag + invalid[..., None]).reshape(Bn, 3 * N)

    def gn_step(poses):
        e, A, Bj = _se2_edge_residuals(poses, graph)
        AtO = A.mT @ Om
        BtO = Bj.mT @ Om
        H = torch.zeros(Bn * N * N, 3, 3, dtype=dt, device=dev)
        index_add(H, blocks, torch.cat(
            [AtO @ A, AtO @ Bj, BtO @ A, BtO @ Bj], 1).reshape(-1, 3, 3),
            deterministic)
        b = torch.zeros(Bn * N, 3, dtype=dt, device=dev)
        index_add(b, ends, torch.cat([AtO @ e[..., None],
                                      BtO @ e[..., None]], 1
                                     ).reshape(-1, 3), deterministic)
        Hd = H.view(Bn, N, N, 3, 3).permute(0, 1, 3, 2, 4).reshape(
            Bn, 3 * N, 3 * N) + torch.diag_embed(diag)
        dx = cho_solve(Hd, -b.view(Bn, 3 * N)).view(Bn, N, 3)
        new = poses + dx
        new = torch.cat([new[..., :2], angle_wrap(new[..., 2:])], -1)
        step = (dx.abs() * graph.node_valid[..., None]).amax((-2, -1))
        return new, step

    poses = graph.node_pose[..., :3]
    active = torch.ones(Bn, dtype=torch.bool, device=dev)
    min_delta = getattr(cfg, "opt_min_delta", 1e-5)
    for _ in range(cfg.opt_iterations):
        new, step = gn_step(poses)
        poses = torch.where(active[:, None, None], new, poses)
        if min_delta > 0:
            active = active & (step >= min_delta)

    # z: linear least squares over the edges' z with unit information
    zs = graph.node_pose[..., 3]
    ez = zs[rows, j] - zs[rows, i] - graph.edge_rel[..., 3]
    wz = w_edge * graph.edge_info[..., 3, 3]
    Hz = torch.zeros(Bn * N * N, dtype=dt, device=dev)
    index_add(Hz, blocks, torch.cat([wz, -wz, -wz, wz], 1).reshape(-1),
              deterministic)
    bz = torch.zeros(Bn * N, dtype=dt, device=dev)
    index_add(bz, ends, torch.cat([-wz * ez, wz * ez], 1).reshape(-1),
              deterministic)
    diagz = torch.full((Bn, N), cfg.lm_lambda, dtype=dt, device=dev)
    diagz[:, 0] = 1e5
    zs = zs + cho_solve(Hz.view(Bn, N, N) + torch.diag_embed(diagz + invalid),
                        -bz.view(Bn, N))

    new_pose = torch.cat([poses, zs[..., None]], -1)
    new_pose = torch.where(graph.node_valid[..., None], new_pose,
                           graph.node_pose)
    delta = new_pose[rows[:, 0], last] - pre_last
    delta = torch.cat([delta[:, :2], angle_wrap(delta[:, 2:3]), delta[:, 3:]],
                      -1)
    return graph.replace(node_pose=new_pose), delta


def relocalization_edge(graph: PoseGraph, belief_pose4: torch.Tensor,
                        match_pose3: torch.Tensor, match_ok: torch.Tensor,
                        cfg):
    """Add an accepted global match (B, 3) as an edge from node 0 to each
    robot's newest keyframe, which it places by composing the match with
    the keyframe's offset from the belief (B, 4) the graph was built in.
    Information diag(reloc_info_xy, reloc_info_xy, reloc_info_yaw, 1). A
    robot with no keyframe but node 0, or no free edge slot, takes no edge
    (the latter counts in edges_dropped). A 6-DoF graph takes the match
    lifted as from_planar lifts an edge: yaw a z-axis rotation vector, the
    information embedded at (0, 1, 5, 2), roll and pitch pinned at 1e4.
    Returns (graph, injected (B,)); optimise afterwards."""
    last, has_last = newest_node(graph)
    rows = _rows(last)
    kf = graph.node_pose[rows, last]
    rel_bk = se2_relative(belief_pose4[:, :3], kf[:, :3])
    kf_map3 = se2_compose(match_pose3, rel_bk)
    node0 = graph.node_pose[:, 0]
    rel = torch.cat([se2_relative(node0[:, :3], kf_map3),
                     (kf[:, 3] - node0[:, 3])[:, None]], -1)
    info = torch.zeros_like(graph.edge_info[:, 0])
    for i, v in enumerate((cfg.reloc_info_xy, cfg.reloc_info_xy,
                           cfg.reloc_info_yaw, 1.0)):
        info[:, i, i] = v
    want = match_ok & has_last & (last != 0)
    e = graph.edge_valid.to(torch.int32).argmin(-1)
    injected = want & ~graph.edge_valid[rows, e]
    rel6 = info6 = None
    if graph.node_rp is not None:
        rel6 = torch.cat([rel[:, :2], rel[:, 3:4],
                          torch.zeros_like(rel[:, :2]), rel[:, 2:3]], -1)
        info6 = pin_roll_pitch(embed_planar_info(info), 1e4)
    g = _add_edge(graph, torch.zeros_like(last), last, want, rel, info,
                  rel6, info6)
    return g, injected


def _kf_world_xyz(graph: PoseGraph) -> torch.Tensor:
    """(B, N, P, 3) keyframe clouds in the world under the node poses:
    SE(2) x z for the planar graph (clouds stored upright), the whole
    SE(3) pose for a 6-DoF graph (clouds in the capture body frame)."""
    pose = graph.node_pose
    if graph.node_rp is not None:
        R = rot3_from_rpy(graph.node_rp[..., 0], graph.node_rp[..., 1],
                          pose[..., 2])
        t = torch.stack([pose[..., 0], pose[..., 1], pose[..., 3]], -1)
        return graph.kf_xyz @ R.mT + t[:, :, None, :]
    qx, qy = se2_apply_xy(pose[..., :3], graph.kf_xyz[..., 0],
                          graph.kf_xyz[..., 1])
    return torch.stack([qx, qy, graph.kf_xyz[..., 2] + pose[..., 3:4]], -1)


def regenerate_map_grid(graph: PoseGraph, capacity: int,
                        resolution: float = 0.5, grid_bins: int = 384,
                        ga_threshold: int = 2,
                        recall: float = 1.0,
                        deterministic: bool = False) -> PointCloud:
    """The scan-to-map target regenerated from every robot's keyframes:
    scatter all keyframe points under the optimised poses into a centroid
    grid of grid_bins cells centred on the newest node (snapped to whole
    cells) and export the `capacity` most observed cells' centroids with
    GA flags from the grid's occupancy.

    recall: slam_tpu passes cfg.cloud.export_recall to its approx_max_k
    export, which equals the exact top-k off the TPU. The port's export is
    always the exact top-k (export_points' stable sort), so recall is
    accepted and has no effect. `deterministic`: the grid's sums the same
    on every run, for a target that several ranks build alike."""
    del recall
    B, N, P, _ = graph.kf_xyz.shape
    xyz = _kf_world_xyz(graph).reshape(B, N * P, 3)
    valid = (graph.kf_valid & graph.node_valid[..., None]).reshape(B, N * P)
    last, _ = newest_node(graph)
    center = torch.round(true_div(graph.node_pose[_rows(last), last, :2],
                                  resolution)) * resolution
    grid = init_point_map(B, grid_bins, resolution,
                          device=xyz.device).replace(center=center)
    grid = update_point_map_xy(grid, xyz[..., 0], xyz[..., 1], xyz[..., 2],
                               valid, resolution, deterministic=deterministic)
    return export_points(grid, capacity, ga_threshold=ga_threshold)


def _kf_world_cloud(graph: PoseGraph, world: torch.Tensor,
                    i: int) -> PointCloud:
    """Keyframe slot i of every robot, in the world, as a (B, P) cloud
    (an invalid node's points masked)."""
    return PointCloud(xyz=world[:, i],
                      valid=graph.kf_valid[:, i] & graph.node_valid[:, i, None],
                      flags=graph.kf_flags[:, i])


def regenerate_map(graph: PoseGraph, capacity: int,
                   voxel_leaf=(0.5, 0.5, 2.0)) -> PointCloud:
    """The scan-to-map target regenerated from every robot's keyframes:
    all keyframe points under the optimised poses, voxel-merged
    (voxel_downsample) into `capacity` points."""
    B, N, P, _ = graph.kf_xyz.shape
    merged = PointCloud(
        xyz=_kf_world_xyz(graph).reshape(B, N * P, 3),
        valid=(graph.kf_valid & graph.node_valid[..., None]).reshape(B, N * P),
        flags=graph.kf_flags.reshape(B, N * P))
    return voxel_downsample(merged, voxel_leaf, capacity)


def regenerate_map_mls(graph: PoseGraph, mls_cfg, capacity: int,
                       deterministic: bool = False):
    """The global map rebuilt as an MLS grid centred on the world origin:
    every keyframe slot's cloud under its optimised pose folded in, slot
    after slot (one batched add_to_mls each), then the cluster means
    exported. Returns (obstacle cloud, ground cloud, grid).
    `deterministic` as regenerate_map_grid's."""
    world = _kf_world_xyz(graph)
    grid = init_mls(mls_cfg, graph.kf_xyz.shape[0], device=world.device)
    for i in range(graph.kf_xyz.shape[1]):
        grid = add_to_mls(grid, _kf_world_cloud(graph, world, i), mls_cfg,
                          deterministic)
    obs, gnd = get_segmented_clouds(grid, mls_cfg, capacity)
    return obs, gnd, grid


# Mission commands: INIT acknowledges (nothing to do), HOME rebuilds the
# global map from keyframe 0 alone with clusters initialized at 3 points,
# so that a robot returning home has a dense target around it; any other
# command is ignored with a warning.
FSM_INIT = 1
FSM_HOME = 2
FSM_FIX = 3


def home_command(graph: PoseGraph, mls_cfg, capacity: int):
    """HOME: the global map from keyframe 0 only. Returns (obstacle cloud,
    ground cloud, node 0's pose (B, 4))."""
    cfg3 = dataclasses.replace(mls_cfg, min_cluster_points=3.0)
    world = _kf_world_xyz(graph)
    grid = add_to_mls(init_mls(cfg3, graph.kf_xyz.shape[0],
                               device=world.device),
                      _kf_world_cloud(graph, world, 0), cfg3)
    obs, gnd = get_segmented_clouds(grid, cfg3, capacity)
    return obs, gnd, graph.node_pose[:, 0]


def mission_command(command: int, graph: PoseGraph, mls_cfg, capacity: int):
    """Dispatch a mission command: FSM_HOME returns home_command's result,
    FSM_INIT None; any other command warns and returns None."""
    if command == FSM_HOME:
        return home_command(graph, mls_cfg, capacity)
    if command == FSM_INIT:
        return None
    warnings.warn(f"Unknown FSM command {command}; ignored", RuntimeWarning,
                  stacklevel=2)
    return None
