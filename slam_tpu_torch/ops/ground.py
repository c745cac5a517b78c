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
form at sim scale, the stable 2-key sort at reference scale).

The sector stage (`gp_sectors`: the height sort, the seeds and the INSAC
sweeps, from the bins' prototypes to the per-bin table the points gather
from) is one launch of a hand-written kernel on the card
(csrc/ground_gp.cu, a block a robot's sector, its sweeps ending when the
sector stops adopting); CPU tensors run its plain version,
`gp_sectors_reference`: batched library Cholesky and triangular solves over
robots x sectors (ops/linalg.py), every sweep in full. Both give f_s that
agrees with slam_tpu's unrolled solver to rounding. slam_tpu's env-gated
alternatives (`packedmin` prototypes, the blocked GP solver) trade
exactness for TPU speed and are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch import cuda_build, true_div
from slam_tpu_torch.ops.linalg import cholesky, forward_substitute
from slam_tpu_torch.types import PointCloud
from slam_tpu_torch.utils import profiling

# z quantized to mm in the low bits of the sort key, under the flat bin
_ZQ_BITS = 20
# signal slots the sector kernel holds in shared memory (its factor and
# substitution are C x C and C x (C + 1) floats)
GP_MAX_SLOTS = 128
# columns of the per-bin table: in the signal, in the model, prototype
# height, regressed height, sector sufficient
TABLE_COLUMNS = 5


class GroundSegResult(NamedTuple):
    cloud: PointCloud                 # flags GROUND / DRIVABLE; valid: classified
    sector_sufficient: torch.Tensor   # (B, S) bool: >= 2 seeds
    model_mask: torch.Tensor          # (B, S, C) adopted signal slots
    f_s: torch.Tensor                 # (B, S, C) regressed ground height


class SectorStage(NamedTuple):
    table: torch.Tensor               # (B, S*L + 1, 5): the bins' rows and
    #                                   a zero row for points off the grid
    sector_sufficient: torch.Tensor   # (B, S) bool
    model_mask: torch.Tensor          # (B, S, C)
    f_s: torch.Tensor                 # (B, S, C)


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
    S, L = cfg.num_sectors, cfg.num_range_bins
    K = S * L
    xyz = cloud.xyz
    B, N, _ = xyz.shape
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
    sec = gp_sectors(count, proto_r, proto_h, cfg)
    g = torch.gather(sec.table, 1,
                     flat.long()[..., None].expand(B, N, TABLE_COLUMNS))
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
    return GroundSegResult(cloud=out, sector_sufficient=sec.sector_sufficient,
                           model_mask=sec.model_mask, f_s=sec.f_s)


def gp_sectors(count: torch.Tensor, proto_r: torch.Tensor,
               proto_h: torch.Tensor, cfg) -> SectorStage:
    """GP-INSAC's sector stage: from each bin's point count and prototype
    (range, height), (B, S, L) each, to the per-bin table the points gather
    from, with each sector's sufficiency, model slots and regressed heights.
    On the card one launch of the sector kernel (counted as
    `ground.launches`); CPU tensors run gp_sectors_reference."""
    if count.device.type == "cpu":
        return gp_sectors_reference(count, proto_r, proto_h, cfg)
    return _gp_sectors_kernel(count, proto_r, proto_h, cfg)


def gp_sectors_reference(count: torch.Tensor, proto_r: torch.Tensor,
                         proto_h: torch.Tensor, cfg) -> SectorStage:
    """gp_sectors' plain version: the sort, seeds and sweeps batched over
    robots x sectors, every sweep in full."""
    B, S, L = count.shape
    dev = count.device
    C = cfg.signal_capacity
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

    # sweep results back to the (S, L) bins
    def to_bins(v):
        return torch.zeros(B, S, L, dtype=v.dtype, device=dev).scatter_(
            -1, order, v)
    zero = torch.zeros_like(f_s)
    table = torch.stack([
        to_bins(sl_valid.to(f_s.dtype)),
        to_bins((m & sl_valid).to(f_s.dtype)),
        proto_h,
        to_bins(torch.where(sl_valid, f_s, zero)),
        sufficient[..., None].expand(B, S, L).to(f_s.dtype),
    ], -1).reshape(B, S * L, TABLE_COLUMNS)
    table = torch.cat([table, table.new_zeros(B, 1, TABLE_COLUMNS)], 1)
    return SectorStage(table=table, sector_sufficient=sufficient,
                       model_mask=m, f_s=f_s)


def gp_shared_bytes(C: int, L: int) -> int:
    """Dynamic shared memory of one block of the sector kernel: the factor
    (C x C) and the substitution (C x (C + 1)), the slots' heights, ranges,
    regressed heights and factor diagonal, the bins' sort keys and slots,
    the model's slot list and the slots' two flags."""
    return 4 * (C * C + C * (C + 1) + 4 * C + L) + 4 * (L + C) + 2 * C


def _gp_sectors_kernel(count, proto_r, proto_h, cfg) -> SectorStage:
    """gp_sectors on the card: one block a (robot, sector). The three
    inputs share their strides, a sector's L bins contiguous (the
    prototypes' views of their (B, S*L + 1) accumulators)."""
    B, S, L = count.shape
    C = min(cfg.signal_capacity, L)
    dev = count.device
    rs = count.stride(0)
    if not 1 <= C <= GP_MAX_SLOTS or B > 65535 or \
            gp_shared_bytes(C, L) > cuda_build.MAX_SMEM:
        raise ValueError(f"the ground GP kernel takes 1 to {GP_MAX_SLOTS} "
                         f"signal slots, at most 65,535 robots and "
                         f"{cuda_build.MAX_SMEM} bytes of shared memory: got "
                         f"C={C}, B={B}, L={L} "
                         f"({gp_shared_bytes(C, L)} bytes)")
    ops = (count, proto_r, proto_h)
    cuda_build.check_operands("ground_gp", ops, [(B, S, L)] * 3,
                              contiguous=(False,) * 3)
    if any(t.stride() != (rs, L, 1) for t in ops):
        raise ValueError(f"the ground GP kernel takes (B, S, L) bins whose "
                         f"sectors are rows of L and whose strides agree: "
                         f"got {[t.stride() for t in ops]}")
    table = torch.empty((B, S * L + 1, TABLE_COLUMNS), dtype=torch.float32,
                        device=dev)
    model = torch.empty((B, S, C), dtype=torch.bool, device=dev)
    f_s = torch.empty((B, S, C), dtype=torch.float32, device=dev)
    sufficient = torch.empty((B, S), dtype=torch.bool, device=dev)
    # the squared distance's divisor as the plain version applies it on
    # the card: a product with the f32 reciprocal of 2 l^2
    inv_two_l2 = float(np.float32(1.0) /
                       np.float32(2.0 * cfg.gp_length_scale ** 2))
    err = cuda_build.library().slam_ground_gp(
        count.data_ptr(), proto_r.data_ptr(), proto_h.data_ptr(), rs,
        table.data_ptr(), model.data_ptr(), f_s.data_ptr(),
        sufficient.data_ptr(),
        profiling.recorded_counter("ground.gp_sweeps", "ground.gp_problems",
                                   B * S, dev), B, S, L, C,
        cfg.max_insac_sweeps, cfg.num_seed_points, cfg.min_bin_points,
        cfg.seed_max_range, cfg.seed_max_height, cfg.gp_signal_var,
        inv_two_l2, cfg.gp_noise, cfg.gp_model_confidence,
        cfg.gp_data_confidence, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "slam_ground_gp")
    profiling.count("ground.launches")
    return SectorStage(table=table, sector_sufficient=sufficient,
                       model_mask=model, f_s=f_s)


def split_ground_obstacle(cloud: PointCloud):
    """(obstacle, ground, non-drivable obstacle) masks of a segmented
    cloud."""
    ground = cloud.valid & cloud.is_ground()
    obstacle = cloud.valid & ~cloud.is_ground()
    drv_over = (cloud.flags & PointCloud.FLAG_DRIVABLE) != 0
    return obstacle, ground, obstacle & ~drv_over
