"""Class-constrained 2D ICP, the "points" matcher — counterpart of
slam_tpu/ops/icp.py (`IcpResult`, `procrustes_2d`, `fit_step`, `icp_fit`,
`edge_information_2d`). icp_fit's pieces (`icp_start`, `transform`,
`fit_update`, `icp_advance`, `icp_result`) are public so that the live
consumer can replay all but the nearest-neighbour kernel from CUDA graphs
(live.GraphedStep).

Batched over robots: scene arrays are (B, S, ...), model arrays (B, C, ...),
poses (B, 3). Correspondences come from nearest_neighbor (kernel K4 on the
card), which takes the first of tied nearest points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from slam_tpu_torch.geometry import angle_wrap, rot2
from slam_tpu_torch.ops.linalg import inv3
from slam_tpu_torch.ops.nn import nearest_neighbor
from slam_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=None)
def _eye(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An identity made once per (n, dtype, device): a fill on the card,
    not a kernel in every step."""
    return torch.eye(n, dtype=dtype, device=device)


class IcpResult(NamedTuple):
    pose: torch.Tensor           # (B, 3) x, y, yaw — scene -> model
    ok: torch.Tensor             # (B,) bool
    num_corr: torch.Tensor       # (B,) int32 inliers at the final step
    delta: torch.Tensor          # (B,) final parameter delta
    mean_residual: torch.Tensor  # (B,) mean inlier squared distance


def procrustes_2d(t_pts, m_pts, w):
    """Weighted 2D Kabsch: (B, N, 2) points, (B, N) weights ->
    (yaw (B,), t (B, 2), wsum (B,)) minimising sum w |m - (R t + t_)|^2."""
    yaw, _, t_, wsum = _procrustes(t_pts, m_pts, w)
    return yaw, t_, wsum


def _procrustes(t_pts, m_pts, w):
    """procrustes_2d, with the rotation R (B, 2, 2) of the yaw too."""
    wsum = torch.clamp(w.sum(-1), min=1e-12)
    mu_t = (w[..., None] * t_pts).sum(-2) / wsum[..., None]
    mu_m = (w[..., None] * m_pts).sum(-2) / wsum[..., None]
    qt = t_pts - mu_t[..., None, :]
    qm = m_pts - mu_m[..., None, :]
    H = (qt * w[..., None]).mT @ qm
    yaw = torch.atan2(H[..., 0, 1] - H[..., 1, 0], H[..., 0, 0] + H[..., 1, 1])
    R = rot2(yaw)
    t_ = mu_m - (R @ mu_t[..., None])[..., 0]
    return yaw, R, t_, wsum


def _class_participation(q_ga, m_ga, m_valid, min_pts=3):
    """A scene point takes part only if the model holds > min_pts points of
    its class."""
    ga_on = (m_valid & m_ga).sum(-1) > min_pts
    nga_on = (m_valid & ~m_ga).sum(-1) > min_pts
    return torch.where(q_ga, ga_on[..., None], nga_on[..., None])


def transform(q_xyz, pose):
    """Scene points (B, S, 2) placed at poses (B, 3)."""
    R = rot2(pose[..., 2])
    return q_xyz @ R.mT + pose[..., :2][..., None, :]


def fit_update(q, idx, d2, participate, m_xyz, pose, inlier_dist):
    """The rest of an ICP step once the placed scene q has its nearest model
    points (idx, d2): (new_pose, delta, num_corr, mean_res)."""
    t = pose[..., :2]
    inlier = participate & (d2 < inlier_dist)
    m_corr = torch.gather(m_xyz, -2, idx.long()[..., None].expand(
        *idx.shape, 2))
    w = inlier.to(q.dtype)
    dyaw, R_, dt, wsum = _procrustes(q, m_corr, w)
    new_yaw = angle_wrap(pose[..., 2] + dyaw)
    new_t = (R_ @ t[..., None])[..., 0] + dt
    new_pose = torch.cat([new_t, new_yaw[..., None]], -1)

    eye = _eye(2, R_.dtype, R_.device)
    frob = torch.sqrt(((R_ - eye) ** 2).sum((-2, -1)))
    delta = torch.maximum(frob, torch.sqrt((dt ** 2).sum(-1)))

    num_corr = inlier.sum(-1).to(torch.int32)
    mean_res = (w * d2).sum(-1) / torch.clamp(wsum, min=1e-12)
    has_corr = num_corr > 0
    new_pose = torch.where(has_corr[..., None], new_pose, pose)
    delta = torch.where(has_corr, delta, -1.0)
    return new_pose, delta, num_corr, mean_res


def fit_step(q_xyz, q_valid, q_ga, m_xyz, m_valid, m_ga, pose, inlier_dist):
    """One ICP step. Returns (new_pose, delta, num_corr, mean_res)."""
    q = transform(q_xyz, pose)
    participate = q_valid & _class_participation(q_ga, m_ga, m_valid)
    idx, d2 = nearest_neighbor(q, m_xyz, m_valid, q_class=q_ga,
                               m_class=m_ga)
    return fit_update(q, idx, d2, participate, m_xyz, pose, inlier_dist)


class IcpLoop(NamedTuple):
    """icp_fit's loop state: every robot's pose and last step's figures,
    and whether it has converged (then it is frozen)."""
    pose: torch.Tensor
    converged: torch.Tensor
    num_corr: torch.Tensor
    mean_res: torch.Tensor
    delta: torch.Tensor


def icp_start(scene_valid, scene_ga, model_valid, model_ga, init_pose, cfg):
    """(ok, participate, the loop's first state) of a fit: a robot takes
    part when it has enough scene and model points; the others start
    converged."""
    ok = (scene_valid.sum(-1) >= cfg.min_scene_points) & \
        (model_valid.sum(-1) >= 5)
    B = init_pose.shape[:-1]
    dev = init_pose.device
    loop = IcpLoop(
        pose=init_pose, converged=~ok,
        num_corr=torch.zeros(B, dtype=torch.int32, device=dev),
        mean_res=torch.zeros(B, dtype=init_pose.dtype, device=dev),
        delta=torch.full(B, float("inf"), dtype=init_pose.dtype, device=dev))
    participate = scene_valid & _class_participation(scene_ga, model_ga,
                                                     model_valid)
    return ok, participate, loop


def icp_advance(loop: IcpLoop, step, min_delta) -> IcpLoop:
    """The loop state after one step (fit_update's result) for the robots
    not yet converged; a robot converges when its delta falls below
    min_delta or it found no correspondence."""
    new_pose, d, nc, mr = step
    c = loop.converged
    return IcpLoop(pose=torch.where(c[..., None], loop.pose, new_pose),
                   converged=c | (d < min_delta) | (d < 0),
                   num_corr=torch.where(c, loop.num_corr, nc),
                   mean_res=torch.where(c, loop.mean_res, mr),
                   delta=torch.where(c, loop.delta, d))


def icp_result(ok, loop: IcpLoop, init_pose) -> IcpResult:
    return IcpResult(pose=torch.where(ok[..., None], loop.pose, init_pose),
                     ok=ok & (loop.num_corr > 0), num_corr=loop.num_corr,
                     delta=loop.delta, mean_residual=loop.mean_res)


def icp_fit(scene_xyz, scene_valid, scene_ga, model_xyz, model_valid,
            model_ga, init_pose, cfg) -> IcpResult:
    """Full ICP fit (<= cfg.max_iterations steps, min_delta convergence).
    Robots that converge are frozen. cfg.loop "while" stops once all have
    (reading that flag is a host sync an iteration, counted as
    `host_syncs`); "scan" runs exactly cfg.max_iterations steps and never
    waits for the card. Both give the same result. The steps run count as
    `icp.fit_iterations` (utils/profiling.py), one a step of the batch."""
    ok, participate, loop = icp_start(scene_valid, scene_ga, model_valid,
                                      model_ga, init_pose, cfg)
    early_exit = cfg.loop == "while"
    for _ in range(cfg.max_iterations):
        if early_exit:
            profiling.count("host_syncs")
            if bool(loop.converged.all()):
                break
        profiling.count("icp.fit_iterations")
        q = transform(scene_xyz, loop.pose)
        idx, d2 = nearest_neighbor(q, model_xyz, model_valid, q_class=scene_ga,
                                   m_class=model_ga)
        loop = icp_advance(loop, fit_update(q, idx, d2, participate, model_xyz,
                                            loop.pose, cfg.inlier_dist),
                           cfg.min_delta)
    return icp_result(ok, loop, init_pose)


def edge_information_2d(t_pts, m_pts, w):
    """Censi / LUM 3x3 information matrix over 2D correspondences: scene
    points t_pts and their model points m_pts (B, N, 2), weights w (B, N).
    Returns (B, 3, 3) information for (x, y, yaw); identity where the
    residual variance is degenerate or not finite."""
    n = torch.clamp(w.sum(-1), min=1.0)
    mid = 0.5 * (m_pts + t_pts)
    diff = m_pts - t_pts
    x, y = mid[..., 0], mid[..., 1]
    dx, dy = diff[..., 0], diff[..., 1]
    sx = (w * x).sum(-1)
    sy = (w * y).sum(-1)
    xpy = (w * (x * x + y * y)).sum(-1)
    zero = torch.zeros_like(n)
    MM = torch.stack([torch.stack([n, zero, -sy], -1),
                      torch.stack([zero, n, sx], -1),
                      torch.stack([-sy, sx, xpy], -1)], -2)
    MZ = torch.stack([(w * dx).sum(-1), (w * dy).sum(-1),
                      (w * (-y * dx + x * dy)).sum(-1)], -1)
    eye = torch.eye(3, dtype=MM.dtype, device=MM.device)
    D = (inv3(MM + 1e-9 * eye) @ MZ[..., None])[..., 0]
    tx = dx - D[..., 0:1] + y * D[..., 2:3]
    ty = dy - D[..., 1:2] - x * D[..., 2:3]
    ss = (w * (tx * tx + ty * ty)).sum(-1) / torch.clamp(2.0 * n - 3.0,
                                                         min=1.0)
    info = MM / torch.clamp(ss, min=1e-12)[..., None, None]
    bad = (ss < 1e-13) | ~torch.isfinite(ss)
    return torch.where(bad[..., None, None], eye, info)
