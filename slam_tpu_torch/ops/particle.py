"""Particle-filter scan matching, BASELINE config 5's matcher — counterpart
of slam_tpu/ops/particle.py, with kernel K5 (`csrc/particle.cu`, replacing
`_pf_scores_pallas`).

Each robot scores P pose particles by how many of its scan points land in
occupied cells of a point-map grid, softmax-weights them, collapses them to
a pose measurement and resamples them systematically. Batched over robots:
scans are (B, N, ...), particles (B, P, 3). The grid is either the robots'
own (batch B) or one map the fleet shares (batch 1).

`score_particles` launches K5 for CUDA tensors (scorer "auto", "pallas" or
"kernel") and runs `score_particles_reference`, the plain PyTorch gather
form of `score_pose`, for CPU tensors and for scorers "gather" and "dense";
every engine gives the same scores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch import cuda_build
from slam_tpu_torch.geometry import angle_wrap
from slam_tpu_torch.mapping.point_map import PointMapGrid

KERNEL_SCORERS = ("auto", "pallas", "kernel")
PLAIN_SCORERS = ("gather", "dense")

# kernel launches made by score_particles (the card path only)
launches = 0


class PFResult(NamedTuple):
    pose: torch.Tensor       # (B, 3) weighted-mean pose
    score: torch.Tensor      # (B,) hit fraction of the returned pose
    ok: torch.Tensor         # (B,) acceptance
    particles: torch.Tensor  # (B, P, 3) resampled particles


def occupancy_flat(grid: PointMapGrid) -> torch.Tensor:
    """(Bg, G*G) bool occupancy table (count > 0; a NaN count, the mark of
    a misaligned merge, is not occupied)."""
    return grid.count.reshape(grid.count.shape[0], -1) > 0


def _hits_reference(grid, sx, sy, valid, px, py, c, s, resolution):
    """Hit counts (B, P) of scan planes (B, N) under particles given as
    (B, P) planes, with c, s the cosine and sine of their yaws."""
    G = grid.count.shape[-1]
    occ = occupancy_flat(grid)                                   # (Bg, G*G)
    wx = c[..., None] * sx[:, None] - s[..., None] * sy[:, None] + \
        px[..., None]                                            # (B, P, N)
    wy = s[..., None] * sx[:, None] + c[..., None] * sy[:, None] + \
        py[..., None]
    rx = wx - grid.center[:, None, None, 0]
    ry = wy - grid.center[:, None, None, 1]
    cx = torch.floor(rx / resolution).to(torch.int32) + G // 2
    cy = torch.floor(ry / resolution).to(torch.int32) + G // 2
    inb = valid[:, None] & (cx >= 0) & (cy >= 0) & (cx < G) & (cy < G)
    flat = (cx.clamp(0, G - 1) * G + cy.clamp(0, G - 1)).long()
    B, P, N = flat.shape
    hit = torch.gather(occ.expand(B, -1), 1, flat.reshape(B, P * N))
    return (inb & hit.reshape(B, P, N)).sum(-1).to(torch.float32)


def _hits_kernel(grid, sx, sy, valid, px, py, c, s, resolution):
    """K5 on the card: the same counts as _hits_reference."""
    global launches
    B, N = sx.shape
    P = px.shape[1]
    Bg, G, _ = grid.count.shape
    if Bg not in (1, B):
        raise ValueError(f"K5 takes a grid of batch 1 or {B}, not {Bg}")
    occ = (grid.count > 0).to(torch.uint8)
    parts = torch.stack([px, py, c, s], -1).contiguous()
    sx, sy, valid = sx.contiguous(), sy.contiguous(), valid.contiguous()
    center = grid.center.contiguous()
    cuda_build.check_operands(
        "K5", (sx, sy, valid, parts, occ, center),
        [(B, N), (B, N), (B, N), (B, P, 4), (Bg, G, G), (Bg, 2)],
        [torch.float32, torch.float32, torch.bool, torch.float32,
         torch.uint8, torch.float32])
    if ((G * G + 15) & ~15) + 9 * N > cuda_build.MAX_SMEM:
        raise ValueError(f"K5 stages a {G}x{G} table and {N} points in "
                         f"shared memory: over {cuda_build.MAX_SMEM} bytes")
    hits = torch.empty((B, P), dtype=torch.float32, device=sx.device)
    err = cuda_build.library().slam_pf_hits(
        sx.data_ptr(), sy.data_ptr(), valid.data_ptr(), parts.data_ptr(),
        occ.data_ptr(), center.data_ptr(), hits.data_ptr(), B, N, P, G,
        resolution, int(Bg == 1),
        torch.cuda.current_stream(sx.device).cuda_stream)
    cuda_build.check(err, "slam_pf_hits")
    launches += 1
    return hits


def _fractions(hits, valid):
    return hits / valid.sum(-1, keepdim=True).clamp(min=1).to(torch.float32)


def score_particles_reference(grid: PointMapGrid, scan_xy: torch.Tensor,
                              valid: torch.Tensor, particles: torch.Tensor,
                              resolution: float) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device: (B, P) hit fractions of
    scans (B, N, 2) with masks (B, N) under particles (B, P, 3)."""
    yaw = particles[..., 2]
    hits = _hits_reference(grid, scan_xy[..., 0], scan_xy[..., 1], valid,
                           particles[..., 0], particles[..., 1],
                           torch.cos(yaw), torch.sin(yaw), resolution)
    return _fractions(hits, valid)


def score_particles(grid: PointMapGrid, scan_xy, valid, particles,
                    resolution: float, cfg) -> torch.Tensor:
    """(B, P) hit fractions — engine dispatch on cfg.scorer (a PfConfig).
    On CUDA tensors "auto", "pallas" and "kernel" launch K5; "gather" and
    "dense" (and every scorer on CPU tensors) run the plain version."""
    engine = cfg.scorer
    if engine not in KERNEL_SCORERS + PLAIN_SCORERS:
        raise ValueError(f"unknown pf.scorer {engine!r} "
                         f"(have {KERNEL_SCORERS + PLAIN_SCORERS})")
    dev = scan_xy.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"score_particles: unsupported device {dev}")
    if dev.type == "cpu" or engine in PLAIN_SCORERS:
        return score_particles_reference(grid, scan_xy, valid, particles,
                                         resolution)
    yaw = particles[..., 2]
    hits = _hits_kernel(grid, scan_xy[..., 0], scan_xy[..., 1], valid,
                        particles[..., 0], particles[..., 1], torch.cos(yaw),
                        torch.sin(yaw), resolution)
    return _fractions(hits, valid)


def score_pose(grid: PointMapGrid, scan_xy, valid, pose,
               resolution: float) -> torch.Tensor:
    """(B,) fraction of each robot's scan points (B, N, 2) landing in
    occupied cells at its pose (B, 3); plain PyTorch."""
    return score_particles_reference(grid, scan_xy, valid, pose[:, None, :],
                                     resolution)[:, 0]


def pf_match(grid: PointMapGrid, scan, pred_pose: torch.Tensor,
             resolution: float, cfg, generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None,
             u: torch.Tensor | None = None) -> PFResult:
    """One particle-filter measurement step for the fleet. scan: a batched
    PointCloud (B, N); pred_pose: (B, 3) EKF predictions, the proposal
    centres; cfg: a PfConfig.

    The draws are `noise` (B, P, 3) standard normals and `u` (B,) uniforms
    in [0, 1), or, where one is None, drawn from `generator`. Particle 0
    sits on the prediction itself."""
    B = pred_pose.shape[0]
    P = cfg.num_particles
    dev = pred_pose.device
    if noise is None or u is None:
        if generator is None:
            raise ValueError("pf_match needs a generator, or both noise and u")
        if noise is None:
            noise = torch.randn((B, P, 3), generator=generator, device=dev)
        if u is None:
            u = torch.rand((B,), generator=generator, device=dev)
    sigma = torch.tensor([cfg.pos_sigma, cfg.pos_sigma, cfg.yaw_sigma],
                         device=dev)
    particles = pred_pose[:, None, :] + noise * sigma
    particles[:, 0] = pred_pose

    st = max(1, int(cfg.score_stride))
    scan_xy = scan.xyz[:, ::st, :2]
    valid = scan.valid[:, ::st]
    scores = score_particles(grid, scan_xy, valid, particles, resolution,
                             cfg)                                 # (B, P)

    w = torch.softmax(scores / cfg.temperature, -1)
    mx = (w * particles[..., 0]).sum(-1)
    my = (w * particles[..., 1]).sum(-1)
    myaw = torch.atan2((w * torch.sin(particles[..., 2])).sum(-1),
                       (w * torch.cos(particles[..., 2])).sum(-1))
    pose = torch.stack([mx, my, angle_wrap(myaw)], -1)

    # systematic resampling (left-side search, as jnp.searchsorted)
    grid_u = (u[:, None] + torch.arange(P, device=dev)) / P
    cdf = torch.cumsum(w, -1)
    idx = torch.searchsorted(cdf, grid_u).clamp(0, P - 1)
    resampled = torch.gather(particles, 1, idx[..., None].expand(-1, -1, 3))

    # the gate reads the score of the returned pose, not the best particle
    out_score = score_particles(grid, scan_xy, valid, pose[:, None, :],
                                resolution, cfg)[:, 0]
    return PFResult(pose=pose, score=out_score, ok=out_score >= cfg.min_score,
                    particles=resampled)

