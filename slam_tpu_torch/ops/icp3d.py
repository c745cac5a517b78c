"""Full 3D point-to-point ICP for the 6-DoF keyframe edges — counterpart of
slam_tpu/ops/icp3d.py (`_class_participation_multi`, `fit_step_3d`,
`icp3d_fit`), batched over problems.

Each step moves the scene by the carried (R, t), finds every point's
nearest model point of its own class (ops/nn.nearest_neighbor, plain
PyTorch in 3D: no TPU kernel stands behind it), gates inliers by squared
distance, solves a weighted 3D Kabsch on the obstacle inliers
(ops/align.rigid_transform_3d, with no host read) and then a z-only
plane fit (z, roll, pitch) on the ground inliers. The loop freezes each
problem once it has converged and follows cfg.loop as slam_tpu does:
"scan" runs all max_iterations steps and never waits for the card;
"while" stops once every problem has converged, at one host read of the
converged flags a step. Both give the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.ops.align import rigid_transform_3d
from slam_tpu_torch.ops.linalg import inv3
from slam_tpu_torch.ops.nn import nearest_neighbor
from slam_tpu_torch.utils import profiling


class Icp3dResult(NamedTuple):
    t: torch.Tensor              # (n, 3) scene -> model translation
    R: torch.Tensor              # (n, 3, 3) scene -> model rotation
    ok: torch.Tensor             # (n,) bool
    num_corr: torch.Tensor       # (n,) int32 inliers at the final step
    delta: torch.Tensor          # (n,) final parameter delta
    mean_residual: torch.Tensor  # (n,) mean inlier squared distance


def _class_participation_multi(q_class, m_class, m_valid, num_classes=3,
                               min_pts=3):
    """(n, S) bool: a scene point takes part only if the model holds more
    than min_pts valid points of its class (0 obstacle, 1 ground-adjacent
    obstacle, 2 ground)."""
    counts = torch.stack([(m_valid & (m_class == c)).sum(-1)
                          for c in range(num_classes)], -1)
    return torch.gather(counts, -1, q_class.long()) > min_pts


def _rot_xy(wx, wy) -> torch.Tensor:
    """Rx(wx) @ Ry(wy) (n, 3, 3), written out (the product's other terms
    are exact zeros)."""
    cx, sx = torch.cos(wx), torch.sin(wx)
    cy, sy = torch.cos(wy), torch.sin(wy)
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([cy, z, sy], -1),
                        torch.stack([sx * sy, cx, -sx * cy], -1),
                        torch.stack([-cx * sy, sx, cx * cy], -1)], -2)


def fit_step_3d(q_xyz, q_valid, q_class, m_xyz, m_valid, m_class, t, R,
                inlier_dist):
    """One step for n problems: scene (n, S, 3) under (R (n, 3, 3), t (n, 3)),
    class-constrained nearest model points (n, C, 3), inliers below
    inlier_dist in squared distance, Kabsch on the obstacle inliers, then
    dz ~= t_z + w_x y - w_y x by least squares on the ground inliers
    (class 2). Returns (new t, new R, delta, num_corr int32, mean
    residual); delta is -1 and the pose kept where nothing corresponds."""
    dt = q_xyz.dtype
    eye = torch.eye(3, dtype=dt, device=q_xyz.device)
    q = q_xyz @ R.mT + t[:, None, :]
    participate = q_valid & _class_participation_multi(q_class, m_class,
                                                       m_valid)
    idx, d2 = nearest_neighbor(q, m_xyz, m_valid, q_class=q_class,
                               m_class=m_class)
    inlier = participate & (d2 < inlier_dist)
    is_ground = q_class == 2
    m_corr = torch.gather(m_xyz, 1, idx.long()[..., None].expand_as(q))

    # stage 1: Kabsch on the obstacle inliers
    w_obs = (inlier & ~is_ground).to(dt)
    step = rigid_transform_3d(q, m_corr, w_obs)
    has_obs = (w_obs.sum(-1) > 0)[:, None]
    R1 = torch.where(has_obs[..., None], step.R, eye)
    t1 = torch.where(has_obs, step.t, 0.0)
    q1 = q @ R1.mT + t1[:, None, :]

    # stage 2: z, roll and pitch from the ground inliers, small angles at
    # the scene frame's origin
    w_gnd = (inlier & is_ground).to(dt)
    dz = m_corr[..., 2] - q1[..., 2]
    A = torch.stack([torch.ones_like(dz), q1[..., 1], -q1[..., 0]], -1)
    AtA = (A * w_gnd[..., None]).mT @ A
    Atb = ((A * dz[..., None]) * w_gnd[..., None]).sum(-2)
    sol = (inv3(AtA + 1e-6 * eye) @ Atb[..., None])[..., 0]
    sol = torch.where((w_gnd.sum(-1) >= 3)[:, None], sol, 0.0)
    R2 = _rot_xy(sol[:, 1], sol[:, 2])
    zero = torch.zeros_like(sol[:, 0])
    t2 = torch.stack([zero, zero, sol[:, 0]], -1)

    # compose: x -> R2 (R1 x + t1) + t2, applied after (R, t)
    R_ = R2 @ R1
    t_ = (R2 @ t1[..., None])[..., 0] + t2
    new_R = R_ @ R
    new_t = (R_ @ t[..., None])[..., 0] + t_
    frob = torch.sqrt(((R_ - eye) ** 2).sum((-1, -2)))
    delta = torch.maximum(frob, torch.linalg.vector_norm(t_, dim=-1))

    num_corr = inlier.sum(-1).to(torch.int32)
    w = inlier.to(dt)
    mean_res = (w * d2).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)
    has_corr = num_corr > 0
    new_t = torch.where(has_corr[:, None], new_t, t)
    new_R = torch.where(has_corr[:, None, None], new_R, R)
    delta = torch.where(has_corr, delta, -1.0)
    return new_t, new_R, delta, num_corr, mean_res


def icp3d_fit(scene_xyz, scene_valid, scene_class, model_xyz, model_valid,
              model_class, init_t, init_R, cfg,
              max_iterations: int | None = None) -> Icp3dResult:
    """3D ICP for n problems: scene (n, S, 3) (node j's keyframe in its
    frame), model (n, C, 3) (node i's), int classes (n, S) / (n, C) (0, 1
    obstacle, 2 ground), init_t (n, 3), init_R (n, 3, 3) the relative
    odometry. ok needs >= cfg.min_scene_points scene and >= 5 model
    points and a correspondence at the last step; a problem that is not
    ok keeps its initial pose. cfg.loop "while" stops once every problem
    has converged (a host read a step), "scan" runs every step."""
    iters = cfg.max_iterations if max_iterations is None else max_iterations
    ok = (scene_valid.sum(-1) >= cfg.min_scene_points) & \
        (model_valid.sum(-1) >= 5)
    n = init_t.shape[0]
    dev, dt = init_t.device, init_t.dtype
    t, R = init_t, init_R
    converged = ~ok
    num_corr = torch.zeros(n, dtype=torch.int32, device=dev)
    mean_res = torch.zeros(n, dtype=dt, device=dev)
    delta = torch.full((n,), float("inf"), dtype=dt, device=dev)
    early_exit = cfg.loop == "while"
    for _ in range(iters):
        if early_exit:
            profiling.count("host_syncs")
            if bool(converged.all()):
                break
        nt, nR, d, nc, mr = fit_step_3d(
            scene_xyz, scene_valid, scene_class, model_xyz, model_valid,
            model_class, t, R, cfg.inlier_dist)
        stop = converged | (d < cfg.min_delta) | (d < 0)
        t = torch.where(converged[:, None], t, nt)
        R = torch.where(converged[:, None, None], R, nR)
        num_corr = torch.where(converged, num_corr, nc)
        mean_res = torch.where(converged, mean_res, mr)
        delta = torch.where(converged, delta, d)
        converged = stop
    t = torch.where(ok[:, None], t, init_t)
    R = torch.where(ok[:, None, None], R, init_R)
    return Icp3dResult(t=t, R=R, ok=ok & (num_corr > 0), num_corr=num_corr,
                       delta=delta, mean_residual=mean_res)
