"""Grid-accelerated class-constrained ICP, the "grid" matcher — counterpart
of slam_tpu/ops/grid_icp.py (`NearestField`, `nearest_point_field`,
`pack_field`, `lookup`, `icp_fit_grid`), batched over robots.

Once a macro, a jump flood over the point-map grid gives every cell the
nearest occupied-cell centroid of each class (NGA, GA); every ICP
iteration's correspondence is then one row gather per scene point
instead of a nearest-neighbour search over the map. The nearest is
resolved from the query's cell centre, so a correspondence can differ
from the exact nearest near the boundary between two centroids.

slam_tpu reaches no Pallas kernel here: the flood is rolls and selects,
the fit a gather and the 2D Procrustes, all plain PyTorch. The fit
freezes converged robots and follows cfg.loop as slam_tpu does: "scan"
runs exactly cfg.max_iterations iterations and never reads a value back
to the host; "while" stops once every robot has converged, at the cost
of one host read of the converged flags an iteration. Both give the
same result.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.geometry import angle_wrap, rot2
from slam_tpu_torch.ops.icp import IcpResult, _eye, procrustes_2d
from slam_tpu_torch.ops.stencil import neighbor_sum_2d
from slam_tpu_torch.parallel.rows import refuse
from slam_tpu_torch.types import Replaceable

BIG = 1e30


@dataclasses.dataclass
class NearestField(Replaceable):
    """Per-cell nearest map centroid of each class (NGA, GA)."""

    px: torch.Tensor       # (B, 2, G, G)
    py: torch.Tensor       # (B, 2, G, G)
    valid: torch.Tensor    # (B, 2, G, G) bool: a centroid within reach
    n_class: torch.Tensor  # (B, 2) int32 occupied cells of each class
    center: torch.Tensor   # (B, 2) world xy of the grid centre
    resolution: float


def _wrap_mask(d: int, G: int, device) -> torch.Tensor:
    """Rows (or columns) whose source, rolled by d, crossed the edge."""
    idx = torch.arange(G, device=device)
    if d > 0:
        return idx < d
    if d < 0:
        return idx >= G + d
    return torch.zeros(G, dtype=torch.bool, device=device)


def nearest_point_field(grid, resolution: float, ga_threshold: int = 2,
                        max_step: int = 4) -> NearestField:
    """Jump-flood the per-class nearest-centroid fields of point-map grids
    (B, G, G) at steps max_step, max_step / 2, ..., 1: the flood reaches
    about 2 * max_step cells, beyond the inlier gate of either config.

    Each step visits the eight neighbours at offset s in slam_tpu's order
    (di, then dj, each in -s, 0, s) and takes a candidate only when it is
    strictly nearer the cell centre, so that order decides ties. A
    candidate rolled in across the grid's edge is dropped. `resolution`
    must equal the grid's own. Not ported to grids split by rows (a jump
    flood over split rows): those raise NotImplementedError."""
    refuse(grid, 'the "grid" matcher\'s nearest-centroid field',
           "the \"grid\" field")
    if abs(resolution - grid.resolution) > 1e-9:
        raise ValueError(
            f"nearest_point_field resolution {resolution} != the map "
            f"grid's own {grid.resolution}; the field must be built and "
            "queried at the grid's cell size")
    G = grid.count.shape[-1]
    dev = grid.count.device
    occ = grid.count > 0
    cnt = torch.clamp(grid.count, min=1.0)
    base = (torch.arange(G, device=dev) - G // 2 + 0.5) * grid.resolution
    base_x = (base[None, :] + grid.center[:, 0:1])[:, :, None]   # (B, G, 1)
    base_y = (base[None, :] + grid.center[:, 1:2])[:, None, :]   # (B, 1, G)
    cx = base_x + grid.sum_x / cnt
    cy = base_y + grid.sum_y / cnt

    box = neighbor_sum_2d((~occ).to(torch.float32))
    ii = torch.arange(G, device=dev)
    inner = (ii > 0) & (ii < G - 1)
    ga = occ & (inner[:, None] & inner[None, :]) & (box >= ga_threshold)
    cls_occ = torch.stack([occ & ~ga, occ & ga], 1)             # (B, 2, G, G)

    ccx = base_x[:, None]                                        # (B, 1, G, 1)
    ccy = base_y[:, None]                                        # (B, 1, 1, G)
    px = torch.where(cls_occ, cx[:, None], 0.0)
    py = torch.where(cls_occ, cy[:, None], 0.0)
    d2 = torch.where(cls_occ, (px - ccx) ** 2 + (py - ccy) ** 2, BIG)
    step = max_step
    while step >= 1:
        for di in (-step, 0, step):
            for dj in (-step, 0, step):
                if di == 0 and dj == 0:
                    continue
                qx = torch.roll(px, (di, dj), (-2, -1))
                qy = torch.roll(py, (di, dj), (-2, -1))
                qd = torch.roll(d2, (di, dj), (-2, -1))
                wrapped = _wrap_mask(di, G, dev)[:, None] | \
                    _wrap_mask(dj, G, dev)[None, :]
                cand = (qx - ccx) ** 2 + (qy - ccy) ** 2
                cand = torch.where(wrapped | (qd >= BIG), BIG, cand)
                take = cand < d2
                px = torch.where(take, qx, px)
                py = torch.where(take, qy, py)
                d2 = torch.where(take, cand, d2)
        step //= 2
    return NearestField(px=px, py=py, valid=d2 < BIG,
                        n_class=cls_occ.sum((-2, -1)).to(torch.int32),
                        center=grid.center, resolution=resolution)


def pack_field(field: NearestField) -> torch.Tensor:
    """(px, py, valid) stacked channel-last into one (B, 2 * G * G, 3) row
    table, so that a lookup is one row gather."""
    B, _, G, _ = field.px.shape
    return torch.stack([field.px, field.py, field.valid.to(field.px.dtype)],
                       -1).reshape(B, 2 * G * G, 3)


def _lookup_packed(table, G: int, center, resolution: float, q, class_row):
    """lookup() against a pack_field table: queries q (B, S, 2) whose
    class's first table row is class_row (B, S) (q_ga * G * G) -> (pt
    (B, S, 2), ok (B, S)). The x and y cells are binned as one (B, S, 2)
    plane, each element as slam_tpu bins it."""
    c = torch.floor(true_div(q - center[:, None, :], resolution)).to(
        torch.int64) + G // 2
    inb = ((c >= 0) & (c < G)).all(-1)
    c = c.clamp(0, G - 1)
    row = class_row + c[..., 0] * G + c[..., 1]
    got = torch.gather(table, 1, row[..., None].expand(-1, -1, 3))
    return got[..., :2], inb & (got[..., 2] > 0.5)


def lookup(field: NearestField, q: torch.Tensor, q_ga: torch.Tensor):
    """Each query's nearest map centroid of its own class: q (B, S, 2),
    q_ga (B, S) -> (pt (B, S, 2), ok (B, S))."""
    G = field.px.shape[-1]
    return _lookup_packed(pack_field(field), G, field.center,
                          field.resolution, q, q_ga.to(torch.int64) * G * G)


def fit_step_grid(table, G: int, field: NearestField, scene_xyz,
                  participate, class_row, pose, inlier_dist: float):
    """One "grid" ICP step of scenes (B, S, 2) from poses (B, 3) against a
    pack_field table: (new_pose, delta, num_corr, mean_res), the pose kept
    and delta -1 where no correspondence was found."""
    dt = pose.dtype
    R = rot2(pose[:, 2])
    q = torch.einsum("bij,bnj->bni", R, scene_xyz) + pose[:, None, :2]
    m_pt, m_ok = _lookup_packed(table, G, field.center, field.resolution,
                                q, class_row)
    d2 = ((q - m_pt) ** 2).sum(-1)
    inlier = participate & m_ok & (d2 < inlier_dist)
    w = inlier.to(dt)
    dyaw, dtr, wsum = procrustes_2d(q, m_pt, w)
    R_ = rot2(dyaw)
    new_pose = torch.cat([
        torch.einsum("bij,bj->bi", R_, pose[:, :2]) + dtr,
        angle_wrap(pose[:, 2] + dyaw)[:, None]], -1)
    eye = _eye(2, dt, pose.device)
    frob = torch.sqrt(((R_ - eye) ** 2).sum((-2, -1)))
    d = torch.maximum(frob, torch.sqrt((dtr ** 2).sum(-1)))
    nc = inlier.sum(-1).to(torch.int32)
    mr = (w * d2).sum(-1) / torch.clamp(wsum, min=1e-12)
    has_corr = nc > 0
    new_pose = torch.where(has_corr[:, None], new_pose, pose)
    d = torch.where(has_corr, d, -1.0)
    return new_pose, d, nc, mr


def icp_fit_grid(scene_xyz, scene_valid, scene_ga, field: NearestField,
                 init_pose, cfg) -> IcpResult:
    """ICP of scenes (B, S, 2) against the nearest-centroid field from
    init_pose (B, 3): up to cfg.max_iterations iterations, a robot frozen
    from the iteration after its step falls below cfg.min_delta or finds
    no correspondence (that iteration's pose is still applied); a class
    takes part only with more than 3 model cells; correspondences farther
    than cfg.inlier_dist (squared) are outliers. ok needs
    cfg.min_scene_points scene points, 5 model cells and a correspondence
    at the end. cfg.loop "while" stops once every robot is frozen (a host
    read an iteration), "scan" runs every iteration without one."""
    ok = (scene_valid.sum(-1) >= cfg.min_scene_points) & \
        (field.n_class.sum(-1) >= 5)
    ga = scene_ga.to(torch.int64)
    participate = scene_valid & torch.gather(field.n_class > 3, 1, ga)
    G = field.px.shape[-1]
    table = pack_field(field)
    class_row = ga * G * G

    B = init_pose.shape[0]
    dev, dt = init_pose.device, init_pose.dtype
    pose = init_pose
    converged = ~ok
    num_corr = torch.zeros(B, dtype=torch.int32, device=dev)
    mean_res = torch.zeros(B, dtype=dt, device=dev)
    delta = torch.full((B,), float("inf"), dtype=dt, device=dev)
    early_exit = cfg.loop == "while"
    for _ in range(cfg.max_iterations):
        if early_exit and bool(converged.all()):
            break
        new_pose, d, nc, mr = fit_step_grid(table, G, field, scene_xyz,
                                            participate, class_row, pose,
                                            cfg.inlier_dist)
        stop = converged | (d < cfg.min_delta) | (d < 0)
        pose = torch.where(converged[:, None], pose, new_pose)
        num_corr = torch.where(converged, num_corr, nc)
        mean_res = torch.where(converged, mean_res, mr)
        delta = torch.where(converged, delta, d)
        converged = stop
    pose = torch.where(ok[:, None], pose, init_pose)
    return IcpResult(pose=pose, ok=ok & (num_corr > 0), num_corr=num_corr,
                     delta=delta, mean_residual=mean_res)
