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
every engine gives the same scores. On the card K5 packs the grid into a
bit table (`occupancy_bits`, one launch) and scores from it (one launch,
reading the scan, mask, particles and centre as they lie); `pf_match`
packs once and scores twice.

On a grid split by rows (`grid.rows`, parallel/rows.py) each rank packs
the words of its slab (cell (ix, iy) is bit ix*G + iy, so a slab of rows
is a contiguous run of words when its cells are a multiple of 32) and the
sp group all-gathers them: K5 then scores, unchanged, against the whole
table, G^2 / 8 bytes a robot.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch import cuda_build
from slam_tpu_torch.geometry import angle_wrap
from slam_tpu_torch.mapping.point_map import PointMapGrid

KERNEL_SCORERS = ("auto", "pallas", "kernel")
PLAIN_SCORERS = ("gather", "dense")

# kernel launches made on the card path: scoring calls, and bit tables
# packed (one a score_particles call, one a pf_match)
launches = 0
pack_launches = 0


class PFConfig(NamedTuple):
    """pf_match's parameters, slam_tpu's ops-level form (config.PfConfig is
    the same fields in the SlamConfig tree; pf_match reads either)."""
    num_particles: int = 128
    pos_sigma: float = 0.3       # proposal spread around the prediction [m]
    yaw_sigma: float = 0.05      # [rad]
    temperature: float = 0.1     # softmax temperature on hit fractions
    min_score: float = 0.2       # acceptance gate (hit fraction)
    score_stride: int = 1        # score every k-th scan point
    scorer: str = "auto"         # KERNEL_SCORERS or PLAIN_SCORERS


class PFResult(NamedTuple):
    pose: torch.Tensor       # (B, 3) weighted-mean pose
    score: torch.Tensor      # (B,) hit fraction of the returned pose
    ok: torch.Tensor         # (B,) acceptance
    particles: torch.Tensor  # (B, P, 3) resampled particles


def occupancy_flat(grid: PointMapGrid) -> torch.Tensor:
    """(Bg, G*G) bool occupancy table (count > 0; a NaN count, the mark of
    a misaligned merge, is not occupied)."""
    return grid.count.reshape(grid.count.shape[0], -1) > 0


def occupancy_bits_reference(count: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's table packing: (Bg, G, G) counts -> (Bg, W)
    int32 words, W = ceil(G*G / 32); cell (ix, iy) is bit (ix*G + iy) % 32
    of word (ix*G + iy) // 32, set where count > 0. A slab of rows (Bg, h,
    G) packs the same way into its own ceil(h*G / 32) words."""
    Bg = count.shape[0]
    n = count[0].numel()
    W = (n + 31) // 32
    occ = count.reshape(Bg, -1) > 0
    occ = torch.nn.functional.pad(occ, (0, W * 32 - n))
    shifts = torch.arange(32, device=count.device, dtype=torch.int64)
    words = (occ.reshape(Bg, W, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def cell_scale(resolution: float) -> float:
    """The factor K5 multiplies by: the f32 reciprocal of the f32
    resolution. PyTorch on the card computes `tensor / python_float` as
    this multiply, so the plain version there does too; for a power-of-two
    resolution it equals the CPU's division bit for bit."""
    return float(np.float32(1.0) / np.float32(resolution))


def score_layout(scan_xy, valid, particles, center) -> list[int]:
    """The element strides K5 reads its operands with: scan view (B, N, 2),
    mask view (B, N), particles (B, P, 3), centre (Bg, 2)."""
    return [*scan_xy.stride(), *valid.stride(), *particles.stride(),
            *center.stride()]


def _hits_reference(grid, sx, sy, valid, px, py, c, s, resolution,
                    bits=None):
    """Hit counts (B, P) of scan planes (B, N) under particles given as
    (B, P) planes, with c, s the cosine and sine of their yaws; the cells
    read from the grid, or from its bit table `bits` (Bg, G*G / 32)."""
    G = grid.count.shape[-1]
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
    flat = flat.reshape(B, P * N)
    if bits is None:
        hit = torch.gather(occupancy_flat(grid).expand(B, -1), 1, flat)
    else:
        word = torch.gather(bits.expand(B, -1), 1, flat >> 5)
        hit = ((word >> (flat & 31)) & 1) != 0
    return (inb & hit.reshape(B, P, N)).sum(-1).to(torch.float32)


def _pack_kernel(count: torch.Tensor, G: int, strides) -> torch.Tensor:
    """One launch of K5's table packing over (Bg, G, G) cells read at
    element `strides` -> (Bg, ceil(G*G / 32)) words."""
    global pack_launches
    Bg = count.shape[0]
    bits = torch.empty((Bg, (G * G + 31) // 32), dtype=torch.int32,
                       device=count.device)
    err = cuda_build.library().slam_pf_pack(
        count.data_ptr(), *strides, Bg, G, bits.data_ptr(),
        torch.cuda.current_stream(count.device).cuda_stream)
    cuda_build.check(err, "slam_pf_pack")
    pack_launches += 1
    return bits


def _slab_words(count: torch.Tensor) -> torch.Tensor:
    """A slab's words (Bg, h*G / 32) of the whole grid's bit table. On the
    card one K5 pack launch reads the slab's cells in flat order as
    squares of 8 x 8 (two words each, so a square's words are the slab's
    own): it needs h*G a multiple of 64."""
    Bg, h, G = count.shape
    n = h * G
    if n % 32:
        raise ValueError(f"a slab of {h} x {G} cells is not word-aligned: "
                         "K5's table splits by rows into whole 32-bit words "
                         "only")
    if count.device.type == "cpu":
        return occupancy_bits_reference(count)
    if count.dtype != torch.float32 or n % 64:
        raise ValueError(f"K5 packs a slab of f32 counts in squares of 64 "
                         f"cells, got {count.dtype} {h} x {G}")
    squares = count.contiguous().view(Bg * n // 64, 8, 8)
    return _pack_kernel(squares, 8, squares.stride()).view(Bg, n // 32)


def occupancy_bits(grid: PointMapGrid) -> torch.Tensor:
    """K5's bit table of the grid: packed on the card by one launch, by
    occupancy_bits_reference for a grid on the CPU. Split by rows, each
    slab's words all-gathered over the sp group: the whole table on every
    rank."""
    count = grid.count
    if grid.rows is not None:
        return torch.cat(grid.rows.comm.all_gather(_slab_words(count)), 1)
    if count.device.type == "cpu":
        return occupancy_bits_reference(count)
    Bg, G, G2 = count.shape
    if count.dtype != torch.float32 or G != G2:
        raise ValueError(f"K5 packs an f32 (Bg, G, G) count grid, got "
                         f"{count.dtype} {tuple(count.shape)}")
    return _pack_kernel(count, G, count.stride())


def _score_kernel(bits, grid, scan_xy, valid, particles, resolution):
    """K5 on the card: (B, P) hit fractions from the bit table `bits` of
    `grid`, reading the other operands through their strides."""
    global launches
    B, N = valid.shape
    P = particles.shape[1]
    Bg, G = grid.count.shape[0], grid.count.shape[-1]
    if Bg not in (1, B):
        raise ValueError(f"K5 takes a grid of batch 1 or {B}, not {Bg}")
    W = (G * G + 31) // 32
    center = grid.center
    cuda_build.check_operands(
        "K5", (scan_xy, valid, particles, center, bits),
        [(B, N, 2), (B, N), (B, P, 3), (Bg, 2), (Bg, W)],
        [torch.float32, torch.bool, torch.float32, torch.float32,
         torch.int32], contiguous=(False,) * 4 + (True,))
    warp = P < 32
    smem = 4 * ((W + 1) & ~1) + 8 * N
    if not warp and smem > cuda_build.MAX_SMEM:
        raise ValueError(f"K5 stages a {G}x{G} bit table and {N} points in "
                         f"shared memory: over {cuda_build.MAX_SMEM} bytes")
    out = torch.empty((B, P), dtype=torch.float32, device=valid.device)
    layout = (ctypes.c_longlong * 10)(*score_layout(scan_xy, valid,
                                                    particles, center))
    err = cuda_build.library().slam_pf_score(
        bits.data_ptr(), G, int(Bg == 1), center.data_ptr(),
        scan_xy.data_ptr(), valid.data_ptr(), particles.data_ptr(),
        out.data_ptr(), B, N, P, cell_scale(resolution), layout, int(warp),
        smem, torch.cuda.current_stream(valid.device).cuda_stream)
    cuda_build.check(err, "slam_pf_score")
    launches += 1
    return out


def _fractions(hits, valid):
    return hits / valid.sum(-1, keepdim=True).clamp(min=1).to(torch.float32)


def _uses_kernel(engine: str, dev: torch.device) -> bool:
    if engine not in KERNEL_SCORERS + PLAIN_SCORERS:
        raise ValueError(f"unknown pf.scorer {engine!r} "
                         f"(have {KERNEL_SCORERS + PLAIN_SCORERS})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"score_particles: unsupported device {dev}")
    return dev.type == "cuda" and engine in KERNEL_SCORERS


def score_particles_reference(grid: PointMapGrid, scan_xy: torch.Tensor,
                              valid: torch.Tensor, particles: torch.Tensor,
                              resolution: float, bits=None) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device: (B, P) hit fractions of
    scans (B, N, 2) with masks (B, N) under particles (B, P, 3). A grid
    split by rows is read through its bit table (`bits`, else gathered by
    occupancy_bits)."""
    if grid.rows is not None and bits is None:
        bits = occupancy_bits(grid)
    yaw = particles[..., 2]
    hits = _hits_reference(grid, scan_xy[..., 0], scan_xy[..., 1], valid,
                           particles[..., 0], particles[..., 1],
                           torch.cos(yaw), torch.sin(yaw), resolution, bits)
    return _fractions(hits, valid)


def score_particles(grid: PointMapGrid, scan_xy, valid, particles,
                    resolution: float, cfg) -> torch.Tensor:
    """(B, P) hit fractions — engine dispatch on cfg.scorer (a PfConfig).
    On CUDA tensors "auto", "pallas" and "kernel" launch K5 (a bit table,
    then the scores); "gather" and "dense" (and every scorer on CPU
    tensors) run the plain version."""
    if not _uses_kernel(cfg.scorer, scan_xy.device):
        return score_particles_reference(grid, scan_xy, valid, particles,
                                         resolution)
    return _score_kernel(occupancy_bits(grid), grid, scan_xy, valid,
                         particles, resolution)


def score_pose(grid: PointMapGrid, scan_xy, valid, pose,
               resolution: float) -> torch.Tensor:
    """(B,) fraction of each robot's scan points (B, N, 2) landing in
    occupied cells at its pose (B, 3); plain PyTorch."""
    return score_particles_reference(grid, scan_xy, valid, pose[:, None, :],
                                     resolution)[:, 0]


_SIGMA: dict = {}


def _sigma(cfg, dev) -> torch.Tensor:
    """(3,) proposal scales [pos, pos, yaw], made once per device."""
    key = (cfg.pos_sigma, cfg.yaw_sigma, dev)
    if key not in _SIGMA:
        _SIGMA[key] = torch.tensor([cfg.pos_sigma, cfg.pos_sigma,
                                    cfg.yaw_sigma], device=dev)
    return _SIGMA[key]


def pf_match(grid: PointMapGrid, scan, pred_pose: torch.Tensor,
             resolution: float, cfg: PFConfig = PFConfig(),
             generator: torch.Generator | None = None,
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
    particles = pred_pose[:, None, :] + noise * _sigma(cfg, dev)
    particles[:, 0] = pred_pose

    st = max(1, int(cfg.score_stride))
    scan_xy = scan.xyz[:, ::st, :2]
    valid = scan.valid[:, ::st]
    if _uses_kernel(cfg.scorer, dev):
        bits = occupancy_bits(grid)        # one table for both scorings

        def score(p):
            return _score_kernel(bits, grid, scan_xy, valid, p, resolution)
    else:
        bits = None if grid.rows is None else occupancy_bits(grid)

        def score(p):
            return score_particles_reference(grid, scan_xy, valid, p,
                                             resolution, bits)
    scores = score(particles)                                     # (B, P)

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
    out_score = score(pose[:, None, :])[:, 0]
    return PFResult(pose=pose, score=out_score, ok=out_score >= cfg.min_score,
                    particles=resampled)

