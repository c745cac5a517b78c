"""Correlative global matching for relocalization — counterpart of
slam_tpu/ops/fft_match.py (`MatchResult`, `rasterize`, `dilate`,
`fft_correlate`, `global_match`), batched over robots.

The search is exhaustive: each robot's scene is rasterized at K rotations
and cross-correlated with its map raster (dilated by smooth_radius cells)
through zero-padded 2D FFTs at (2G, 2G), so every translation at every
rotation is scored; rotations go through in chunks of the largest divisor
of K within rot_chunk, which gives the same scores as one pass. The best
cell, first maximum on ties as in slam_tpu, is then polished by the
"points" ICP (`ops/icp.icp_fit`, whose nearest neighbours run on kernel K4
on the card) with every class flag off.

The score is the matched fraction of occupied scene raster cells, in
[0, 1]; a match is accepted above accept_score. The correlation values are
integer overlap counts carrying the FFT's rounding, which differs between
FFT libraries: where lags tie on the integer, which one wins is decided
by that rounding. The scores are not rounded, as slam_tpu does not round
them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from slam_tpu_torch import true_div
from slam_tpu_torch.geometry import angle_wrap, rot2
from slam_tpu_torch.ops.icp import icp_fit
from slam_tpu_torch.types import PointCloud
from slam_tpu_torch.utils.profiling import stage


class MatchResult(NamedTuple):
    pose: torch.Tensor   # (B, 3) scene -> map x, y, yaw (wrapped)
    score: torch.Tensor  # (B,) matched fraction of occupied scene cells
    ok: torch.Tensor     # (B,) accepted?


def rasterize(xy: torch.Tensor, valid: torch.Tensor, center: torch.Tensor,
              cfg) -> torch.Tensor:
    """Binary occupancy rasters (..., G, G) of points xy (..., N, 2) around
    center (..., 2)."""
    G = cfg.grid_size
    lead = xy.shape[:-2]
    N = xy.shape[-2]
    q = torch.floor(true_div(xy - center[..., None, :], cfg.grid_resolution)
                    ).to(torch.int32) + G // 2
    inb = valid & ((q >= 0) & (q < G)).all(-1)
    # a point off the raster writes 0 to a cell chosen by its index: under
    # max it changes nothing, and the card's atomics do not pile onto one
    # spare cell
    spread = torch.arange(N, device=xy.device) % (G * G)
    flat = torch.where(inb, q[..., 0] * G + q[..., 1], spread).long()
    img = torch.zeros(lead + (G * G,), dtype=torch.float32, device=xy.device)
    img.scatter_reduce_(-1, flat, inb.to(torch.float32), reduce="amax")
    return img.view(lead + (G, G))


def dilate(img: torch.Tensor, radius: int) -> torch.Tensor:
    """`radius` passes of a 3 x 3 max over (..., G, G) rasters (zero
    padding and max-pooling's -inf padding agree on 0/1 images)."""
    lead = img.shape[:-2]
    x = img.reshape((-1,) + img.shape[-2:])
    for _ in range(radius):
        x = F.max_pool2d(x, 3, stride=1, padding=1)
    return x.view(lead + img.shape[-2:])


def fft_correlate(map_img: torch.Tensor, scene_imgs: torch.Tensor,
                  map_spectrum: torch.Tensor | None = None) -> torch.Tensor:
    """Linear cross-correlation (..., c, 2G, 2G) of each scene raster
    (..., c, G, G) against its map raster (..., G, G), by rFFT zero-padded
    to 2G. Lag (i, j) is the signed shift (i if i < G else i - 2G, likewise
    j). map_spectrum: rfft2(map_img, s=(2G, 2G)), when the caller scores
    several chunks against one map."""
    G = map_img.shape[-1]
    pad = (2 * G, 2 * G)
    F_map = torch.fft.rfft2(map_img, s=pad) if map_spectrum is None \
        else map_spectrum
    F_scn = torch.fft.rfft2(scene_imgs, s=pad)
    return torch.fft.irfft2(F_map.unsqueeze(-3) * torch.conj(F_scn), s=pad)


def global_match(scene: PointCloud, map_cloud: PointCloud,
                 prior_xy: torch.Tensor, cfg,
                 icp_cfg=None) -> MatchResult:
    """Each robot's scene pose in its map near prior_xy (B, 2): scene a
    robot-frame cloud (B, N), map_cloud a world-frame cloud (B, M). With
    icp_cfg, an accepted polish replaces the coarse pose."""
    K = cfg.num_rotations
    G = cfg.grid_size
    P = 2 * G
    chunk = max(c for c in range(1, max(1, cfg.rot_chunk) + 1) if K % c == 0)
    dev = prior_xy.device
    angles = torch.arange(K, device=dev).to(torch.float32) * (
        2 * math.pi / K)

    map_img = dilate(rasterize(map_cloud.xyz[..., :2], map_cloud.valid,
                               prior_xy, cfg), cfg.smooth_radius)
    F_map = torch.fft.rfft2(map_img, s=(P, P))
    sxy = scene.xyz[..., :2]
    zero = torch.zeros_like(prior_xy)[:, None, :]
    idxs, bests, cells = [], [], []
    for c0 in range(0, K, chunk):
        R = rot2(angles[c0:c0 + chunk])                        # (c, 2, 2)
        xy = sxy[:, None] @ R.mT                                # (B, c, N, 2)
        imgs = rasterize(xy, scene.valid[:, None], zero, cfg)   # (B, c, G, G)
        corr = fft_correlate(map_img, imgs, map_spectrum=F_map)
        flat = corr.flatten(-2)
        idx = flat.argmax(-1)
        idxs.append(idx)
        bests.append(torch.gather(flat, -1, idx[..., None])[..., 0])
        cells.append(imgs.sum((-2, -1)))
    flat_idx = torch.cat(idxs, -1)                              # (B, K)
    frac = torch.cat(bests, -1) / torch.clamp(torch.cat(cells, -1), min=1.0)
    k = frac.argmax(-1)
    ij = torch.gather(flat_idx, -1, k[:, None])[:, 0]
    si, sj = ij // P, ij % P
    dx = torch.where(si >= G, si - P, si).to(torch.float32)
    dy = torch.where(sj >= G, sj - P, sj).to(torch.float32)
    trans = torch.stack([dx, dy], -1) * cfg.grid_resolution + prior_xy
    coarse = torch.cat([trans, angle_wrap(angles[k])[:, None]], -1)
    score = torch.gather(frac, -1, k[:, None])[:, 0]

    pose = coarse
    if icp_cfg is not None:
        off_s = torch.zeros_like(scene.valid)
        off_m = torch.zeros_like(map_cloud.valid)
        with stage("reloc.polish"):
            res = icp_fit(sxy, scene.valid, off_s, map_cloud.xyz[..., :2],
                          map_cloud.valid, off_m, coarse, icp_cfg)
        pose = torch.where(res.ok[:, None], res.pose, coarse)
    return MatchResult(pose=pose, score=score, ok=score > cfg.accept_score)
