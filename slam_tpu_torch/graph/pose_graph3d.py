"""6-DoF pose-graph optimisation — counterpart of slam_tpu/graph/pose_graph3d.py
(`so3_hat`, `so3_exp`, `so3_log`, `quat_to_rot`, `rot_to_quat`,
`Se3Graph`, `init_se3_graph`, `from_planar`, `edge_information_lum6`,
`_edge_residuals_se3`, `optimize_se3`, `optimize_planar`, `from_native`,
`optimize_native`, `total_chi2`), batched over robots.

A robot's SE(3) graph holds node rotations and translations and edges
with a measured relative pose and a 6 x 6 information in the tangent
order [t_x, t_y, t_z, w_x, w_y, w_z]. The optimiser is Gauss-Newton on
the manifold: nodes move by t <- t + R dt, R <- R Exp(dw). slam_tpu
linearises all residuals with one jax.jacfwd over the (N, 6) tangent;
each residual depends only on its two end nodes, so here every edge's
two 6 x 6 Jacobian blocks are written in closed form,

    e_t = Rz^T (Ri^T (tj - ti) - z_t),  e_r = Log(Rz^T Ri^T Rj) = phi
    de_t/dti = -Rz^T     de_t/dwi = Rz^T [Ri^T (tj - ti)]x
    de_t/dtj = Rz^T Ri^T Rj
    de_r/dwi = -Jr^-1(phi) Rj^T Ri     de_r/dwj = Jr^-1(phi)

and the normal matrix is assembled with index_add_ into (N*N, 6, 6)
blocks and solved by Cholesky (ops/linalg.cho_solve). slam_tpu's
while-loop early exit becomes all iterations with each robot frozen once
its largest valid-node step falls below min_delta (that step applied),
which is what its while loop under vmap gives. Nothing reads a device
value from Python.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.geometry import angle_wrap, rot3_from_rpy
from slam_tpu_torch.ops.linalg import cho_solve
from slam_tpu_torch.ops.scatter2d import index_add
from slam_tpu_torch.types import PoseGraph, Replaceable


# ------------------------------------------------------------------ SO(3)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew matrices (..., 3, 3) of vectors (..., 3)."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotations (..., 3, 3) of rotation vectors (..., 3), the
    Taylor forms of sin(t)/t and (1 - cos t)/t^2 below t^2 = 1e-12."""
    t2 = (w * w).sum(-1)
    t = torch.sqrt(torch.where(t2 > 0, t2, 1.0))
    small = t2 < 1e-12
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.where(small, 1.0, t2))
    K = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (..., 3) of rotations (..., 3, 3): the Taylor form
    below t ~ 4.5e-3 (where f32 cos t saturates), the axis from the
    largest diagonal row of R + I within ~1e-3 of pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    near0 = cos_t > 1.0 - 1e-5
    big = cos_t < -1.0 + 5e-7
    edge = near0 | big
    t = torch.arccos(torch.where(edge, 0.0, cos_t))
    t = torch.where(near0, 0.0, torch.where(big, math.pi, t))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    t2s = (v * v).sum(-1) * 0.25
    sin_t = torch.sin(torch.where(edge, math.pi / 2, t))
    scale = torch.where(near0, 0.5 + t2s / 12.0, t / (2.0 * sin_t))
    w_generic = v * scale[..., None]
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], -1)
    k = diag.argmax(-1)
    row = torch.gather(B, -2, k[..., None, None].expand(*k.shape, 1, 3)
                       )[..., 0, :]
    nrm = torch.linalg.vector_norm(row, dim=-1, keepdim=True)
    w_pi = row / torch.where(nrm > 1e-12, nrm, 1.0) * t[..., None]
    return torch.where(big[..., None], w_pi, w_generic)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[w, x, y, z] quaternions (..., 4), normalised -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotations (..., 3, 3) -> [w, x, y, z] with w >= 0: Shepperd's four
    candidates, the one with the largest denominator taken."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22
    cands = torch.stack([torch.clamp(1.0 + tr, min=0.0),
                         torch.clamp(1.0 + r00 - r11 - r22, min=0.0),
                         torch.clamp(1.0 - r00 + r11 - r22, min=0.0),
                         torch.clamp(1.0 - r00 - r11 + r22, min=0.0)], -1)
    k = cands.argmax(-1)
    s = 2.0 * torch.sqrt(torch.clamp(torch.gather(cands, -1, k[..., None]
                                                  )[..., 0], min=1e-12))
    qw = torch.stack([s * 0.25, (r21 - r12) / s, (r02 - r20) / s,
                      (r10 - r01) / s], -1)
    qx = torch.stack([(r21 - r12) / s, s * 0.25, (r01 + r10) / s,
                      (r02 + r20) / s], -1)
    qy = torch.stack([(r02 - r20) / s, (r01 + r10) / s, s * 0.25,
                      (r12 + r21) / s], -1)
    qz = torch.stack([(r10 - r01) / s, (r02 + r20) / s, (r12 + r21) / s,
                      s * 0.25], -1)
    kk = k[..., None]
    q = torch.where(kk == 0, qw, torch.where(kk == 1, qx,
                                             torch.where(kk == 2, qy, qz)))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# --------------------------------------------------------- the SE(3) graph


@dataclasses.dataclass
class Se3Graph(Replaceable):
    """Fixed-capacity 6-DoF pose graphs, one a robot.

    node_t:     (B, N, 3) translations
    node_R:     (B, N, 3, 3) rotations
    node_valid: (B, N) bool
    edge_ij:    (B, E, 2) int32 from, to
    edge_t:     (B, E, 3) measured relative translation (from-frame)
    edge_R:     (B, E, 3, 3) measured relative rotation
    edge_info:  (B, E, 6, 6) information, tangent order [t; w]
    edge_valid: (B, E) bool
    """

    node_t: torch.Tensor
    node_R: torch.Tensor
    node_valid: torch.Tensor
    edge_ij: torch.Tensor
    edge_t: torch.Tensor
    edge_R: torch.Tensor
    edge_info: torch.Tensor
    edge_valid: torch.Tensor


def init_se3_graph(batch: int, max_nodes: int, max_edges: int, device=None,
                   dtype=torch.float32) -> Se3Graph:
    """Empty SE(3) graphs, on the card unless `device` says otherwise."""
    device = default_device(device)
    B, N, E = batch, max_nodes, max_edges
    eye = torch.eye(3, dtype=dtype, device=device)
    return Se3Graph(
        node_t=torch.zeros(B, N, 3, dtype=dtype, device=device),
        node_R=eye.repeat(B, N, 1, 1),
        node_valid=torch.zeros(B, N, dtype=torch.bool, device=device),
        edge_ij=torch.zeros(B, E, 2, dtype=torch.int32, device=device),
        edge_t=torch.zeros(B, E, 3, dtype=dtype, device=device),
        edge_R=eye.repeat(B, E, 1, 1),
        edge_info=torch.zeros(B, E, 6, 6, dtype=dtype, device=device),
        edge_valid=torch.zeros(B, E, dtype=torch.bool, device=device))


def _rot_z(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def embed_planar_info(info4: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) information in (x, y, yaw, z) -> (..., 6, 6) at the
    tangent indices (0, 1, 5, 2), zeros elsewhere (a selection matrix
    product: every term but one is an exact zero)."""
    eye6 = torch.eye(6, dtype=info4.dtype, device=info4.device)
    P = torch.stack([eye6[:, 0], eye6[:, 1], eye6[:, 5], eye6[:, 2]], -1)
    return P @ info4 @ P.mT


def planar_info(info6: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) -> the (..., 4, 4) block at tangent indices (0, 1, 5, 2),
    i.e. (x, y, yaw, z)."""
    eye6 = torch.eye(6, dtype=info6.dtype, device=info6.device)
    P = torch.stack([eye6[:, 0], eye6[:, 1], eye6[:, 5], eye6[:, 2]], -1)
    return P.mT @ info6 @ P


def pin_roll_pitch(info6: torch.Tensor, rp) -> torch.Tensor:
    """info6 with rp (a float or (...) tensor) added at (3, 3) and (4, 4)."""
    eye6 = torch.eye(6, dtype=info6.dtype, device=info6.device)
    pin = eye6[3, :, None] * eye6[3] + eye6[4, :, None] * eye6[4]
    if isinstance(rp, torch.Tensor):
        rp = rp[..., None, None]
    return info6 + rp * pin


def from_planar(graph: PoseGraph, rp_info: float = 1e4) -> Se3Graph:
    """Lift the planar SE(2) x z graphs into SE(3): yaw becomes a z-axis
    rotation, the (x, y, yaw, z) information embeds at tangent indices
    (0, 1, 5, 2), and valid edges pin roll and pitch at rp_info (the
    planar model measures them as 0)."""
    p, r = graph.node_pose, graph.edge_rel
    rp = torch.where(graph.edge_valid, rp_info, 0.0).to(graph.edge_info.dtype)
    return Se3Graph(
        node_t=torch.stack([p[..., 0], p[..., 1], p[..., 3]], -1),
        node_R=_rot_z(p[..., 2]), node_valid=graph.node_valid,
        edge_ij=graph.edge_ij,
        edge_t=torch.stack([r[..., 0], r[..., 1], r[..., 3]], -1),
        edge_R=_rot_z(r[..., 2]),
        edge_info=pin_roll_pitch(embed_planar_info(graph.edge_info), rp),
        edge_valid=graph.edge_valid)


# ------------------------------------------------- 6 x 6 LUM information


def edge_information_lum6(source_trans: torch.Tensor, target: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """LUM information (n, 6, 6) of n registered problems: source points
    (n, P, 3) under the edge transform, their matched targets (n, P, 3),
    0/1 correspondence weights (n, P). With aver = (s + t) / 2 and
    diff = s - t, the normal equations of diff ~= J(aver) D with rows

        J_x = [1 0 0     0      -aver_y  aver_z]
        J_y = [0 1 0  -aver_z    aver_x    0   ]
        J_z = [0 0 1   aver_y      0    -aver_x]

    give info = J^T J / s^2, s^2 the residual sum of squares after the
    solve; the identity where that is degenerate (below 1e-13, not
    finite, or fewer than 7 correspondences)."""
    dt = source_trans.dtype
    aver = 0.5 * (source_trans + target)
    diff = source_trans - target
    ax, ay, az = aver.unbind(-1)
    zero, one = torch.zeros_like(ax), torch.ones_like(ax)
    J = torch.stack([
        torch.stack([one, zero, zero, zero, -ay, az], -1),
        torch.stack([zero, one, zero, -az, ax, zero], -1),
        torch.stack([zero, zero, one, ay, zero, -ax], -1)], -2)  # (n, P, 3, 6)
    n, P = w.shape
    Jf = J.reshape(n, P * 3, 6)
    wJ = (J * w[..., None, None]).reshape(n, P * 3, 6)
    MM = wJ.mT @ Jf
    MZ = (wJ.mT @ diff.reshape(n, P * 3, 1))[..., 0]
    eye6 = torch.eye(6, dtype=dt, device=w.device)
    D = cho_solve(MM + eye6 * 1e-9, MZ)
    r = diff - (J @ D[:, None, :, None])[..., 0]
    ss = (w[..., None] * r * r).sum((-1, -2))
    bad = (ss < 1e-13) | ~torch.isfinite(ss) | (w.sum(-1) < 7)
    info = MM / torch.where(bad, 1.0, ss)[:, None, None]
    return torch.where(bad[:, None, None], eye6, info)


# ------------------------------------------------------------ optimiser


def _edge_ends(graph: Se3Graph, x: torch.Tensor):
    """x (B, N, ...) at every edge's from and to node: two (B, E, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return (x[rows, graph.edge_ij[..., 0].long()],
            x[rows, graph.edge_ij[..., 1].long()])


def _edge_residuals_se3(node_t, node_R, graph: Se3Graph) -> torch.Tensor:
    """Residuals (B, E, 6) of every edge:
    e = [Rz^T (Ri^T (tj - ti) - z_t); Log(Rz^T Ri^T Rj)]."""
    ti, tj = _edge_ends(graph, node_t)
    Ri, Rj = _edge_ends(graph, node_R)
    local = (Ri.mT @ (tj - ti)[..., None])[..., 0]
    et = (graph.edge_R.mT @ (local - graph.edge_t)[..., None])[..., 0]
    return torch.cat([et, so3_log(graph.edge_R.mT @ Ri.mT @ Rj)], -1)


def _jr_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) (..., 3, 3) at phi (..., 3):
    I + K/2 + (1/t^2 - cos(t/2) / (2 t sin(t/2))) K^2, the coefficient's
    Taylor form 1/12 + t^2/720 below t^2 = 1e-6."""
    t2 = (phi * phi).sum(-1)
    small = t2 < 1e-6
    t = torch.sqrt(torch.where(small, 1.0, t2))
    half = 0.5 * t
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / torch.where(small, 1.0, t2) -
                    torch.cos(half) / (2.0 * t * torch.sin(half)))
    K = so3_hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + c[..., None, None] * (K @ K)


def _edge_jacobians(node_t, node_R, graph: Se3Graph):
    """Residuals e (B, E, 6) and their Jacobians A = de/dx_i, Bj = de/dx_j
    (B, E, 6, 6) in the body tangent [dt; dw] of each end node."""
    ti, tj = _edge_ends(graph, node_t)
    Ri, Rj = _edge_ends(graph, node_R)
    RzT = graph.edge_R.mT
    local = (Ri.mT @ (tj - ti)[..., None])[..., 0]
    et = (RzT @ (local - graph.edge_t)[..., None])[..., 0]
    RiTRj = Ri.mT @ Rj
    phi = so3_log(RzT @ RiTRj)
    Jinv = _jr_inv(phi)
    zero = torch.zeros_like(RzT)
    A = torch.cat([torch.cat([-RzT, RzT @ so3_hat(local)], -1),
                   torch.cat([zero, -Jinv @ RiTRj.mT], -1)], -2)
    Bj = torch.cat([torch.cat([RzT @ RiTRj, zero], -1),
                    torch.cat([zero, Jinv], -1)], -2)
    return torch.cat([et, phi], -1), A, Bj


def optimize_se3(graph: Se3Graph, iterations: int = 10,
                 lm_lambda: float = 1e-3, gauge_weight: float = 1e5,
                 min_delta: float = 1e-5,
                 deterministic: bool = False) -> Se3Graph:
    """Dense Gauss-Newton / LM on SE(3) for every robot: node 0 holds a
    gauge_weight prior, every node lm_lambda damping and every invalid
    node a unit regulariser; all `iterations` steps run, each robot frozen
    once its largest valid-node update falls below min_delta (> 0).
    `deterministic`: the normal equations summed the same on every run
    (scatter2d.index_add), for graphs that several ranks hold alike."""
    Bn, N = graph.node_valid.shape
    dev, dt = graph.node_t.device, graph.node_t.dtype
    rows = torch.arange(Bn, device=dev)[:, None]
    i = graph.edge_ij[..., 0].long()
    j = graph.edge_ij[..., 1].long()
    Om = graph.edge_info * graph.edge_valid.to(dt)[..., None, None]
    base = rows * N
    blocks = torch.cat([(base + i) * N + i, (base + i) * N + j,
                        (base + j) * N + i, (base + j) * N + j], 1).reshape(-1)
    ends = torch.cat([base + i, base + j], 1).reshape(-1)
    diag = torch.full((Bn, N, 6), lm_lambda, dtype=dt, device=dev)
    diag[:, 0] = gauge_weight
    diag = (diag + (~graph.node_valid).to(dt)[..., None]).reshape(Bn, 6 * N)
    valid = graph.node_valid[..., None]

    t, R = graph.node_t, graph.node_R
    active = torch.ones(Bn, dtype=torch.bool, device=dev)
    for _ in range(iterations):
        e, A, Bj = _edge_jacobians(t, R, graph)
        AtO = A.mT @ Om
        BtO = Bj.mT @ Om
        H = torch.zeros(Bn * N * N, 6, 6, dtype=dt, device=dev)
        index_add(H, blocks, torch.cat(
            [AtO @ A, AtO @ Bj, BtO @ A, BtO @ Bj], 1).reshape(-1, 6, 6),
            deterministic)
        b = torch.zeros(Bn * N, 6, dtype=dt, device=dev)
        index_add(b, ends, torch.cat([AtO @ e[..., None],
                                      BtO @ e[..., None]], 1
                                     ).reshape(-1, 6), deterministic)
        Hd = H.view(Bn, N, N, 6, 6).permute(0, 1, 3, 2, 4).reshape(
            Bn, 6 * N, 6 * N) + torch.diag_embed(diag)
        dx = cho_solve(Hd, -b.view(Bn, 6 * N)).view(Bn, N, 6)
        nt = t + (R @ dx[..., :3, None])[..., 0]
        nR = R @ so3_exp(dx[..., 3:])
        step = (dx.abs() * valid).amax((-2, -1))
        t = torch.where(active[:, None, None], nt, t)
        R = torch.where(active[:, None, None, None], nR, R)
        if min_delta > 0:
            active = active & (step >= min_delta)
    return graph.replace(
        node_t=torch.where(valid, t, graph.node_t),
        node_R=torch.where(valid[..., None], R, graph.node_R))


def _yaw(R: torch.Tensor) -> torch.Tensor:
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def _planar_result(graph: PoseGraph, se3: Se3Graph, **extra):
    """(graph with node_pose (x, y, yaw, z) from se3 on valid nodes and
    `extra` fields, delta (B, 4) of the newest node, yaw wrapped)."""
    # pose_graph imports this module
    from slam_tpu_torch.graph.pose_graph import newest_node
    last, _ = newest_node(graph)
    rows = torch.arange(last.shape[0], device=last.device)
    t = se3.node_t
    new_pose = torch.stack([t[..., 0], t[..., 1], _yaw(se3.node_R),
                            t[..., 2]], -1)
    new_pose = torch.where(graph.node_valid[..., None], new_pose,
                           graph.node_pose)
    delta = new_pose[rows, last] - graph.node_pose[rows, last]
    delta = torch.cat([delta[:, :2], angle_wrap(delta[:, 2:3]),
                       delta[:, 3:]], -1)
    return graph.replace(node_pose=new_pose, **extra), delta


def optimize_planar(graph: PoseGraph, cfg, deterministic: bool = False):
    """pose_graph.optimize's contract through the SE(3) solver (engine
    "se3" over planar edges): lift with from_planar, optimise, project back
    to (x, y, yaw, z). Returns (graph, delta (B, 4) of the newest node)."""
    se3 = optimize_se3(from_planar(graph), iterations=cfg.opt_iterations,
                       lm_lambda=cfg.lm_lambda,
                       min_delta=getattr(cfg, "opt_min_delta", 1e-5),
                       deterministic=deterministic)
    return _planar_result(graph, se3)


def from_native(graph: PoseGraph) -> Se3Graph:
    """The SE(3) problem of a 6-DoF graph (edge_registration "3d"): node
    rotations from roll, pitch and yaw, edges straight from edge_rel6
    ([t; rotation vector]) and edge_info6."""
    p = graph.node_pose
    return Se3Graph(
        node_t=torch.stack([p[..., 0], p[..., 1], p[..., 3]], -1),
        node_R=rot3_from_rpy(graph.node_rp[..., 0], graph.node_rp[..., 1],
                             p[..., 2]),
        node_valid=graph.node_valid, edge_ij=graph.edge_ij,
        edge_t=graph.edge_rel6[..., :3],
        edge_R=so3_exp(graph.edge_rel6[..., 3:]),
        edge_info=graph.edge_info6, edge_valid=graph.edge_valid)


def optimize_native(graph: PoseGraph, cfg, deterministic: bool = False):
    """Optimise a 6-DoF graph over its measured 6-DoF edges (engine "se3"
    with edge_registration "3d"): writes (x, y, yaw, z) and node_rp back
    on valid nodes. Returns (graph, delta (B, 4) of the newest node)."""
    se3 = optimize_se3(from_native(graph), iterations=cfg.opt_iterations,
                       lm_lambda=cfg.lm_lambda,
                       min_delta=getattr(cfg, "opt_min_delta", 1e-5),
                       deterministic=deterministic)
    R = se3.node_R
    # ZYX Euler angles, the inverse of rot3_from_rpy
    pitch = -torch.arcsin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    rp = torch.where(graph.node_valid[..., None],
                     torch.stack([roll, pitch], -1), graph.node_rp)
    return _planar_result(graph, se3, node_rp=rp)


def total_chi2(graph: Se3Graph) -> torch.Tensor:
    """(B,) sum of e^T Omega e over each robot's valid edges."""
    e = _edge_residuals_se3(graph.node_t, graph.node_R, graph)
    chi = (e[..., None, :] @ graph.edge_info @ e[..., :, None])[..., 0, 0]
    return (chi * graph.edge_valid.to(e.dtype)).sum(-1)
