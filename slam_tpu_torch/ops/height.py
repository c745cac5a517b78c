"""Wheel-contact height interpolation — counterpart of
slam_tpu/ops/height.py, batched over robots.

Four wheel points under the robot find their nearest ground points (within
sqrt(max_nn_dist_sq), the first of tied nearest); the robot's z is the mean
matched ground height plus robot_height along the normal of the plane
fitted through the matches. The normal is the smallest eigenvector of the
3x3 scatter, in closed form (Cardano), with the vertical as the fallback
when the matches are degenerate.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.ops.scatter2d import gather_cells_2d
from slam_tpu_torch.parallel.rows import all_sum, owner_of, owner_select


def _plane_normal(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Unit normals (B, 3) of the best-fit planes through weighted points
    pts (B, 4, 3), weights w (B, 4)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    mu = (w[..., None] * pts).sum(-2) / wsum[..., None]
    d = (pts - mu[:, None, :]) * w[..., None]
    S = d.transpose(-1, -2) @ d
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    q = (S[:, 0, 0] + S[:, 1, 1] + S[:, 2, 2]) / 3.0
    Bm = S - q[:, None, None] * eye
    p = torch.sqrt(torch.clamp((Bm * Bm).sum((-1, -2)) / 6.0, min=1e-20))
    det_b = (Bm[:, 0, 0] * (Bm[:, 1, 1] * Bm[:, 2, 2] -
                            Bm[:, 1, 2] * Bm[:, 2, 1])
             - Bm[:, 0, 1] * (Bm[:, 1, 0] * Bm[:, 2, 2] -
                              Bm[:, 1, 2] * Bm[:, 2, 0])
             + Bm[:, 0, 2] * (Bm[:, 1, 0] * Bm[:, 2, 1] -
                              Bm[:, 1, 1] * Bm[:, 2, 0]))
    r = torch.clamp(det_b / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    # eigenvector of lam_min: the largest cross product of rows of S - l I
    A = S - lam_min[:, None, None] * eye
    crosses = torch.stack([torch.linalg.cross(A[:, 0], A[:, 1]),
                           torch.linalg.cross(A[:, 0], A[:, 2]),
                           torch.linalg.cross(A[:, 1], A[:, 2])], 1)
    norms2 = (crosses * crosses).sum(-1)                      # (B, 3)
    best, k = norms2.max(-1)
    c = torch.gather(crosses, 1, k[:, None, None].expand(-1, 1, 3))[:, 0]
    n = c / torch.clamp(torch.sqrt(best), min=1e-12)[:, None]
    degenerate = (lam_mid < 1e-6) | (best < 1e-24)
    # (0, 0, 1) made on the device: a tensor from a host list, or an
    # element set from a Python number, is a copy that waits for the card
    up = (torch.arange(3, device=n.device) == 2).to(n.dtype)
    return torch.where(degenerate[:, None], up, n)


def height_interpolate_planes(gx, gy, gz, gvalid, pose_xyyawz: torch.Tensor,
                              cfg) -> torch.Tensor:
    """New z (B,) from ground planes (B, N) and poses (B, 4) [x, y, yaw,
    z]; the old z where fewer than min_corr_points wheels find ground."""
    x, y, yaw, z0 = pose_xyyawz.unbind(-1)
    xw, yw = cfg.x_wheel_dist, cfg.y_wheel_dist
    # wheels (-xw, -yw), (-xw, yw), (xw, -yw), (xw, yw), made on the device
    # (a tensor from a host list is a copy that waits for the card)
    k = torch.arange(4, device=gx.device)
    wl = torch.stack([xw * (2 * (k // 2) - 1), yw * (2 * (k % 2) - 1)],
                     -1).to(gx.dtype)
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    wx = wl[:, 0] * c - wl[:, 1] * s + x[:, None]             # (B, 4)
    wy = wl[:, 0] * s + wl[:, 1] * c + y[:, None]
    wz = z0 - cfg.robot_height

    d2 = (wx[..., None] - gx[:, None, :]) ** 2 + \
        (wy[..., None] - gy[:, None, :]) ** 2 + \
        (wz[:, None, None] - gz[:, None, :]) ** 2 + \
        torch.where(gvalid[:, None, :], 0.0, 1e30)            # (B, 4, N)
    dmin = d2.amin(-1)
    tie = d2 <= dmin[..., None]
    first = (tie & (torch.cumsum(tie.to(torch.int32), -1) == 1)).to(gx.dtype)
    corr = torch.stack([(first * gx[:, None, :]).sum(-1),
                        (first * gy[:, None, :]).sum(-1),
                        (first * gz[:, None, :]).sum(-1)], -1)  # (B, 4, 3)
    ok = dmin < cfg.max_nn_dist_sq
    w = ok.to(corr.dtype)
    avg = (w[..., None] * corr).sum(-2) / torch.clamp(w.sum(-1),
                                                      min=1e-9)[:, None]
    n = _plane_normal(corr, w)
    n = torch.where(n[:, 2:3] < 0, -n, n)
    new_z = n[:, 2] * cfg.robot_height + avg[:, 2]
    good = (ok.sum(-1) >= cfg.min_corr_points) & torch.isfinite(n).all(-1)
    return torch.where(good, new_z, z0)


def height_interpolate_grid(grid, pose_xyyawz: torch.Tensor,
                            cfg) -> torch.Tensor:
    """height_interpolate straight off the ground centroid grid: the
    occupied cells of the window that any accepted match must lie in.
    On a grid split by rows the window may cross slabs: each rank reads
    the window cells of its rows, and one owner_select joins them by the
    cell's row, so every rank of the group gets the same window."""
    rows = grid.rows
    G = grid.count.shape[-1]
    res = float(grid.resolution)
    reach = math.hypot(cfg.x_wheel_dist, cfg.y_wheel_dist)
    half = int(math.ceil((math.sqrt(cfg.max_nn_dist_sq) + reach) / res)) + 1
    W = min(2 * half + 1, G)
    rel = pose_xyyawz[:, :2] - grid.center
    ci = torch.floor(true_div(rel[:, 0], res)).to(torch.int32) + G // 2
    cj = torch.floor(true_div(rel[:, 1], res)).to(torch.int32) + G // 2
    i0 = torch.clamp(ci - (W - 1) // 2, 0, G - W)
    j0 = torch.clamp(cj - (W - 1) // 2, 0, G - W)
    ar = torch.arange(W, device=ci.device)
    ii = (i0[:, None] + ar)[:, :, None].expand(-1, W, W)
    jj = (j0[:, None] + ar)[:, None, :].expand(-1, W, W)
    ci_read = ii.reshape(-1, W * W)
    if rows is not None:
        ci_read = ci_read - rows.r0
    cells = torch.stack(gather_cells_2d(
        (grid.count, grid.sum_x, grid.sum_y, grid.sum_z), ci_read,
        jj.reshape(-1, W * W)), -1)                          # (B, W * W, 4)
    if rows is not None:
        cells = owner_select(cells, owner_of(ii.reshape(-1, W * W), rows),
                             rows)
    cnt, sx, sy, sz = cells.unbind(-1)
    occ = cnt >= 1.0
    safe = torch.clamp(cnt, min=1.0)
    iif = ii.reshape(-1, W * W).to(grid.center.dtype)
    jjf = jj.reshape(-1, W * W).to(grid.center.dtype)
    ctr_x = (iif - G // 2 + 0.5) * res + grid.center[:, 0:1]
    ctr_y = (jjf - G // 2 + 0.5) * res + grid.center[:, 1:2]
    return height_interpolate_planes(ctr_x + sx / safe, ctr_y + sy / safe,
                                     sz / safe, occ, pose_xyyawz, cfg)


def occupied_cells(grid) -> torch.Tensor:
    """(B,) the occupied cells (count >= 1) of each robot's ground grid,
    the whole grid's: summed over the sp group on a slab."""
    return all_sum((grid.count >= 1.0).sum((1, 2)), grid.rows)


def height_interpolate(ground, pose_xyyawz: torch.Tensor,
                       cfg) -> torch.Tensor:
    """height_interpolate_planes on a world-frame ground PointCloud."""
    return height_interpolate_planes(ground.xyz[..., 0], ground.xyz[..., 1],
                                     ground.xyz[..., 2], ground.valid,
                                     pose_xyyawz, cfg)
