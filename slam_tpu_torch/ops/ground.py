"""GP-INSAC ground segmentation — counterpart of slam_tpu/ops/ground.py
(`segment_ground`, `split_ground_obstacle`), batched over robots.

Per scan: points fall into a polar grid of sectors x range bins; each bin's
prototype is its lowest point (z quantized to mm, ties to the first scan
index); per sector, the valid prototypes sorted by height form the signal;
INSAC grows a GP ground model from the lowest seeds, sweep by sweep; bin
points are then ground, obstacle or drivable-over obstacle.

One exact engine serves every scan size: a stable sort of each scan by the
packed key (bin, mm-quantized z) puts each bin's prototype first in its
segment, and `index_add_` accumulates counts and prototypes. It gives the
prototypes of both of slam_tpu's exact engines (the (N, bins) incidence
form at sim scale, the stable 2-key sort at reference scale). The GP solves
are batched library Cholesky and triangular solves over robots x sectors
(ops/linalg.py); their f_s agrees with slam_tpu's unrolled solver to
rounding. slam_tpu's env-gated alternatives (`packedmin` prototypes, the
blocked GP solver) trade exactness for TPU speed and are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.ops.linalg import cholesky, forward_substitute
from slam_tpu_torch.types import PointCloud

# z quantized to mm in the low bits of the sort key, under the flat bin
_ZQ_BITS = 20


class GroundSegResult(NamedTuple):
    cloud: PointCloud                 # flags GROUND / DRIVABLE; valid: classified
    sector_sufficient: torch.Tensor   # (B, S) bool: >= 2 seeds
    model_mask: torch.Tensor          # (B, S, C) adopted signal slots
    f_s: torch.Tensor                 # (B, S, C) regressed ground height


def _gp_kernel(r: torch.Tensor, cfg) -> torch.Tensor:
    """Squared-exponential kernel over ranges: (..., C) -> (..., C, C)."""
    d = r[..., :, None] - r[..., None, :]
    return cfg.gp_signal_var * torch.exp(-(d * d) /
                                         (2.0 * cfg.gp_length_scale ** 2))


def _bin_prototypes(flat, zq, r2, z, K):
    """Per-bin point counts and the prototype's (range, z): the point of
    lowest zq, ties to the first scan index. flat (B, N) in [0, K], K the
    sentinel of points outside the grid. Returns (count, proto_r, proto_h),
    each (B, K)."""
    B, N = flat.shape
    key = (flat.to(torch.int64) << _ZQ_BITS) | zq.to(torch.int64)
    key, order = torch.sort(key, dim=-1, stable=True)
    sf = key >> _ZQ_BITS
    first = torch.ones_like(sf, dtype=torch.bool)
    first[:, 1:] = sf[:, 1:] != sf[:, :-1]
    rows = torch.arange(B, device=flat.device)[:, None] * (K + 1)
    idx = (rows + sf).reshape(-1)
    out = []
    for v in (torch.ones_like(r2), torch.gather(r2, 1, order),
              torch.gather(z, 1, order)):
        # one prototype per bin: each sum has a single non-zero term, so
        # the order of the additions cannot change it
        vv = v if not out else torch.where(first, v, 0.0)
        acc = torch.zeros(B * (K + 1), dtype=v.dtype, device=v.device)
        acc.index_add_(0, idx, vv.reshape(-1))
        out.append(acc.view(B, K + 1)[:, :K])
    return out


def polar_bins(phi: torch.Tensor, r2: torch.Tensor, cfg):
    """(sector, range bin) int32 of each point: phi its bearing in degrees
    [0, 360), r2 its planar range. The sector is clamped to [0, S); the
    range bin is not. Sector widths (22.5 deg at sim3d, 5 at the reference
    scale) and range bins (1.875 m at sim3d) are no powers of two, so both
    quotients are true divisions (true_div) and the card bins as the CPU
    does."""
    S, L = cfg.num_sectors, cfg.num_range_bins
    sector = torch.clamp(true_div(phi, 360.0 / S).to(torch.int32), 0, S - 1)
    return sector, true_div(r2, cfg.r_max / L).to(torch.int32)


def segment_ground(cloud: PointCloud, cfg) -> GroundSegResult:
    """Classify sensor-frame clouds (B, N, 3), roll / pitch compensated, z
    up, into ground / obstacle / drivable-over obstacle."""
    S, L, C = cfg.num_sectors, cfg.num_range_bins, cfg.signal_capacity
    K = S * L
    xyz = cloud.xyz
    B, N, _ = xyz.shape
    dev = xyz.device
    x, y, z = xyz.unbind(-1)
    r3 = torch.sqrt(x * x + y * y + z * z)
    r2 = torch.sqrt(x * x + y * y)
    phi = torch.atan2(y, x) * (180.0 / math.pi)
    phi = torch.where(phi < 0, phi + 360.0, phi)
    sector, lbin = polar_bins(phi, r2, cfg)
    ok = cloud.valid & (r3 < cfg.r_max) & (lbin >= 0) & (lbin < L)
    flat = torch.where(ok, sector * L + lbin, K)
    # ok points have |z| < r_max << 524 m: mm quantization fits 20 bits
    zq = torch.clamp(torch.round((z + 500.0) * 1000.0), 0,
                     2 ** _ZQ_BITS - 2)
    zq = torch.where(ok, zq, 0.0).to(torch.int32)
    count, proto_r, proto_h = (a.reshape(B, S, L) for a in
                               _bin_prototypes(flat, zq, r2, z, K))
    sig_valid = count > cfg.min_bin_points

    # per-sector signal, height-sorted, capacity C
    key = torch.where(sig_valid, proto_h, float("inf"))
    order = torch.argsort(key, dim=-1, stable=True)[..., :C]      # (B, S, C)
    sl_h = torch.gather(proto_h, -1, order)
    sl_r = torch.gather(proto_r, -1, order)
    sl_valid = torch.gather(sig_valid, -1, order)
    C = order.shape[-1]

    # seeds: up to num_seed_points lowest qualifying prototypes
    qual = sl_valid & (sl_r < cfg.seed_max_range) & \
        (sl_h.abs() < cfg.seed_max_height)
    npt = torch.clamp(sl_valid.sum(-1), max=cfg.num_seed_points)
    rank = torch.cumsum(qual.to(torch.int32), -1)
    seed = qual & (rank <= npt[..., None])
    sufficient = seed.sum(-1) >= 2

    # INSAC sweeps: regress on the model, adopt every inlier at once;
    # converged sectors keep their last regression
    Kall = _gp_kernel(sl_r, cfg)                                  # (B,S,C,C)
    eye = torch.eye(C, dtype=Kall.dtype, device=dev)
    m = seed
    active = sufficient & (sl_valid & ~seed).any(-1)
    f_s = torch.zeros_like(sl_h)
    for _ in range(cfg.max_insac_sweeps):
        mf = m.to(Kall.dtype)
        M = Kall * mf[..., :, None] * mf[..., None, :] + \
            cfg.gp_noise * mf[..., None, :] * eye + \
            (1.0 - mf)[..., None, :] * eye
        Bm = Kall * mf[..., None, :]
        rhs = torch.cat([(sl_h * mf)[..., None], Bm.transpose(-1, -2)], -1)
        Y = forward_substitute(cholesky(M), rhs)
        w, Yb = Y[..., 0], Y[..., 1:]
        f = torch.einsum("...jc,...j->...c", Yb, w)
        v = cfg.gp_signal_var - (Yb * Yb).sum(-2)
        met = (sl_h - f) / torch.sqrt(cfg.gp_noise + v * v)
        inlier = sl_valid & ~m & (v < cfg.gp_model_confidence) & \
            (met.abs() < cfg.gp_data_confidence) & active[..., None]
        m = m | inlier
        f_s = torch.where(active[..., None], f, f_s)
        active = active & inlier.any(-1) & (sl_valid & ~m).any(-1)

    # sweep results back to the (S, L) bins, then to the points
    def to_bins(v):
        return torch.zeros(B, S, L, dtype=v.dtype, device=dev).scatter_(
            -1, order, v)
    zero = torch.zeros_like(f_s)
    table = torch.stack([
        to_bins(sl_valid.to(z.dtype)),
        to_bins((m & sl_valid).to(z.dtype)),
        proto_h,
        to_bins(torch.where(sl_valid, f_s, zero)),
        sufficient[..., None].expand(B, S, L).to(z.dtype),
    ], -1).reshape(B, K, 5)
    table = torch.cat([table, table.new_zeros(B, 1, 5)], 1)
    g = torch.gather(table, 1, flat.long()[..., None].expand(B, N, 5))
    p_sig_valid = ok & (g[..., 0] > 0.5)
    p_model = g[..., 1] > 0.5
    p_proto_h = g[..., 2]
    p_f = g[..., 3]
    p_suff = g[..., 4] > 0.5

    # model bins: ground within ground_threshold of the prototype; other
    # bins are obstacles when the sector model was sufficient
    h_model = (p_proto_h - z).abs()
    is_ground = p_sig_valid & p_model & (h_model < cfg.ground_threshold)
    obs_model = p_sig_valid & p_model & ~is_ground
    obs_nonmodel = p_sig_valid & ~p_model & p_suff
    h_ref = torch.where(p_model, h_model, (z - p_f).abs())
    is_obs = obs_model | obs_nonmodel
    drivable_over = is_obs & (h_ref > cfg.robot_height)
    flags = torch.where(is_ground, PointCloud.FLAG_GROUND, 0) | \
        torch.where(drivable_over, PointCloud.FLAG_DRIVABLE, 0)
    out = cloud.replace(valid=is_ground | is_obs,
                        flags=flags.to(torch.int32))
    return GroundSegResult(cloud=out, sector_sufficient=sufficient,
                           model_mask=m, f_s=f_s)


def split_ground_obstacle(cloud: PointCloud):
    """(obstacle, ground, non-drivable obstacle) masks of a segmented
    cloud."""
    ground = cloud.valid & cloud.is_ground()
    obstacle = cloud.valid & ~cloud.is_ground()
    drv_over = (cloud.flags & PointCloud.FLAG_DRIVABLE) != 0
    return obstacle, ground, obstacle & ~drv_over
