"""Rigid alignment of corresponding 3D point sets — counterpart of
slam_tpu/ops/align.py (`rigid_transform_3d`, `apply_se2_to_cloud`),
batched over problems.

slam_tpu solves the weighted Kabsch problem with an SVD of the 3x3
cross-covariance H. On a CUDA tensor torch.linalg.svd and eigh wait for
the card (they report convergence to the host), and the 3D edge fit calls
this once an ICP iteration for every edge problem. So the SVD is a fixed
number of one-sided Jacobi sweeps in tensor ops (`kabsch_rotation`), with
no host read. It works on H itself: an eigen-solve of H^T H squares H's
condition, and a keyframe's obstacles can be one long wall (singular
values 3000 : 3.5 : 0), where that costs a tenth of a radian in f32.
The rotation is unique wherever rank(H) >= 2, and there it equals
slam_tpu's to f32 rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


# one-sided Jacobi sweeps (three plane rotations each) of the Kabsch SVD:
# from V = I, 3 already bring random problems (walls, planes, any
# rotation) to 1.1e-6 of the f64 rotation; one more for margin
JACOBI_SWEEPS = 4
# H has rank < 2 where its second largest singular value falls below this
# share of its norm: the rotation is not unique there
RANK2_SHARE = 1e-6


class RigidResult(NamedTuple):
    R: torch.Tensor      # (..., 3, 3)
    t: torch.Tensor      # (..., 3)
    rmse: torch.Tensor   # (...)


def _jacobi_planes(dtype, device):
    """For each plane (p, q) of a sweep: e_p e_p^T + e_q e_q^T and
    e_p e_q^T - e_q e_p^T, (3, 3, 3) each."""
    eye = torch.eye(3, dtype=dtype, device=device)
    pairs = ((0, 1), (0, 2), (1, 2))
    diag = torch.stack([eye[:, p, None] * eye[p] + eye[:, q, None] * eye[q]
                        for p, q in pairs])
    skew = torch.stack([eye[:, p, None] * eye[q] - eye[:, q, None] * eye[p]
                        for p, q in pairs])
    return pairs, diag, skew


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """The rotation R (..., 3, 3) maximising tr(R H) for cross-covariances
    H = sum w (a - ca)(b - cb)^T (..., 3, 3): SVD-Kabsch's
    V diag(1, 1, d) U^T with d = det(V U^T).

    The SVD is one-sided Jacobi in tensor ops: JACOBI_SWEEPS sweeps of
    plane rotations J turn G = H V (V = I at first, G, V <- G J, V J) until
    G's columns are orthogonal, G = U S. V stays a rotation, so with k the
    column of the least singular value and (a, b, k) in cyclic order,
    R = sum over i != k of v_i u_i^T + v_k (u_a x u_b)^T: u_k is never
    divided out, which keeps rank(H) = 2 exact. Where rank(H) < 2 the
    rotation is not unique, and this gives the identity."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    scale = torch.sqrt((H * H).sum((-1, -2)))
    G = H / torch.clamp(scale, min=1e-30)[..., None, None]
    V = eye.expand_as(G)
    pairs, diag, skew = _jacobi_planes(H.dtype, H.device)
    for _ in range(JACOBI_SWEEPS):
        for n, (p, q) in enumerate(pairs):
            W = G.mT @ G
            a, b, g = W[..., p, p], W[..., q, q], W[..., p, q]
            d = b - a
            # tan of the angle that zeroes column p . column q, the smaller
            # root; 45 degrees where the columns have equal norms
            t = 2.0 * g * torch.where(d >= 0, 1.0, -1.0) / torch.clamp(
                d.abs() + torch.sqrt(d * d + 4.0 * g * g), min=1e-30)
            c = torch.rsqrt(1.0 + t * t)
            J = eye + (c - 1.0)[..., None, None] * diag[n] + \
                (c * t)[..., None, None] * skew[n]
            G = G @ J
            V = V @ J
    s = torch.linalg.vector_norm(G, dim=-2)                    # (..., 3)
    U = G / torch.clamp(s, min=1e-30)[..., None, :]
    u0, u1, u2 = U.unbind(-1)
    crossed = torch.stack([torch.linalg.cross(u1, u2),
                           torch.linalg.cross(u2, u0),
                           torch.linalg.cross(u0, u1)], -1)
    least = s.argmin(-1)
    k = torch.arange(3, device=H.device) == least[..., None]
    U = torch.where(k[..., None, :], crossed, U)
    R = V @ U.mT
    second = s.sum(-1) - s.amax(-1) - s.amin(-1)
    return torch.where((second > RANK2_SHARE)[..., None, None], R, eye)


def rigid_transform_3d(a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor | None = None) -> RigidResult:
    """R, t minimising sum w_i |R a_i + t - b_i|^2 for points a, b
    (..., N, 3) and weights w (..., N) (all ones when None), with the
    weighted RMSE of the fit."""
    if w is None:
        w = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    ws = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    ca = (w[..., None] * a).sum(-2) / ws
    cb = (w[..., None] * b).sum(-2) / ws
    H = ((a - ca[..., None, :]) * w[..., None]).mT @ (b - cb[..., None, :])
    R = kabsch_rotation(H)
    t = cb - (R @ ca[..., None])[..., 0]
    res = a @ R.mT + t[..., None, :] - b
    rmse = torch.sqrt((w[..., None] * res * res).sum((-1, -2)) / ws[..., 0])
    return RigidResult(R=R, t=t, rmse=rmse)


def apply_se2_to_cloud(xyz: torch.Tensor, dx, dy, dyaw) -> torch.Tensor:
    """Shift clouds (..., N, 3) by an SE(2) map offset (dx, dy, dyaw)."""
    if isinstance(dyaw, torch.Tensor):
        c, s = torch.cos(dyaw), torch.sin(dyaw)
    else:
        c, s = math.cos(dyaw), math.sin(dyaw)
    x = c * xyz[..., 0] - s * xyz[..., 1] + dx
    y = s * xyz[..., 0] + c * xyz[..., 1] + dy
    return torch.stack([x, y, xyz[..., 2]], -1)
