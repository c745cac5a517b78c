"""Multi-level-surface (MLS) grid — counterpart of slam_tpu/mapping/mls.py
(`init_mls`, `shift_origin_mls`, `add_to_mls` with its association,
segment-sum, merge, spawn, sort and ground-pair phases, `_drivability`,
`offset_mls_z`, `get_segmented_clouds`), batched over robots.

Each cell holds a bank of K Gaussian z-clusters sorted by mean z, empty
slots last. A scan updates the grid in three phases, as in slam_tpu:
(A) every point picks a cluster slot of its cell (an initialized cluster
within the gate, else the nearest uninitialized one within robot_height,
else a new cluster, else it is dropped); (B) the points are summed per
(cell, slot); (C) the sums merge into the running Gaussians, each cell
spawns at most one new cluster, the bank is re-sorted, the ground pair
merges when its clearance is below cluster_combine_dist, and one
synchronous stencil pass refreshes the drivability of the touched cells.

slam_tpu writes the per-cell slot choices as one-hot masks and applies
the bank's sort as an einsum permutation, because per-cell indexing
serializes on a TPU. Here the slots are argmax / gather and the sort
scatters each slot to its stable rank, which select the same slots and
values exactly; phase B is one `index_add_` of five channels.

On a grid split by rows (`grid.rows`, parallel/rows.py) the shift rolls
every bank through one ring over the sp group, a scan's fold keeps the
points of the slab's rows (every phase is per cell), the drivability
stencil takes a one-row halo (+inf beyond the grid's edges, as its
padding), and get_segmented_clouds merges each slab's top clusters over
the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_tpu_torch import default_device, true_div
from slam_tpu_torch.ops.roll import fresh_mask, roll_cells, shift_step
from slam_tpu_torch.parallel.rows import halo, merge_top, whole_rows
from slam_tpu_torch.types import MlsGrid, PointCloud


def init_mls(cfg, batch: int, device=None, dtype=torch.float32) -> MlsGrid:
    """Empty grids, on the card unless `device` says otherwise."""
    device = default_device(device)
    H, W, K = cfg.size_x, cfg.size_y, cfg.max_clusters

    def z(*shape, dt=dtype):
        return torch.zeros((batch,) + shape, dtype=dt, device=device)
    return MlsGrid(mean=z(H, W, K, 3), var_z=z(H, W, K), num_pts=z(H, W, K),
                   drivable=torch.full((batch, H, W), -1, dtype=torch.int8,
                                       device=device),
                   origin=z(2, dt=torch.int32), center=z(2))


def shift_origin_mls(grid: MlsGrid, new_center_xy: torch.Tensor,
                     cfg) -> MlsGrid:
    """Re-centre each robot's grid on new_center_xy (B, 2) by whole cells.
    Cluster means are stored relative to the centre, so the surviving
    means move by -d * resolution; cells entering the window are cleared."""
    d, center = shift_step(grid.center, new_center_xy, cfg.resolution)
    H, W = grid.drivable.shape[1:]
    fresh = fresh_mask(d, H, W, rows=grid.rows)
    mean, var_z, num, drv = roll_cells(
        (grid.mean, grid.var_z, grid.num_pts, grid.drivable), d, grid.rows)
    off = torch.stack([-d[:, 0].to(mean.dtype) * cfg.resolution,
                       -d[:, 1].to(mean.dtype) * cfg.resolution,
                       torch.zeros_like(center[:, 0])], -1)
    mean = torch.where(fresh[..., None, None], 0.0,
                       mean + off[:, None, None, None, :])
    var_z = torch.where(fresh[..., None], 0.0, var_z)
    num = torch.where(fresh[..., None], 0.0, num)
    drv = torch.where(fresh, -1, drv)
    return grid.replace(mean=mean, var_z=var_z, num_pts=num, drivable=drv,
                        center=center)


def _first_true(mask: torch.Tensor):
    """(index, any) of the first True along the last (K) axis; index 0
    where there is none."""
    return mask.to(torch.uint8).argmax(-1), mask.any(-1)


def _pick(arr: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """arr (..., K) at slot idx (...) where ok, else 0."""
    K = arr.shape[-1]
    v = torch.gather(arr, -1, idx.clamp(max=K - 1)[..., None])[..., 0]
    return torch.where(ok, v, 0.0)


def _onehot(idx: torch.Tensor, ok: torch.Tensor, K: int) -> torch.Tensor:
    return (torch.arange(K, device=idx.device) == idx[..., None]) & \
        ok[..., None]


def _sort_k(key: torch.Tensor, arrs):
    """Stable ascending sort along the K axis by `key` (inf marks empty
    slots), applied to every array in `arrs`: each slot's rank (the slots
    with a smaller key, or an equal key and a lower index, before it; K^2
    compares for K = max_clusters, a handful) and one scatter to it. On
    the card torch.sort of millions of K-long rows runs a radix sort that
    cost ~13 ms a call at config 3's (128, 192, 192, 4) banks."""
    K = key.shape[-1]
    ki, kj = key[..., :, None], key[..., None, :]
    idx = torch.arange(K, device=key.device)
    before = (kj < ki) | ((kj == ki) & (idx[None, :] < idx[:, None]))
    rank = before.sum(-1)
    return [torch.empty_like(a).scatter_(-1, rank, a) for a in arrs]


def _associate(grid: MlsGrid, cell: torch.Tensor, z: torch.Tensor,
               inb: torch.Tensor, cfg) -> torch.Tensor:
    """Phase A: each point's cluster slot in [0, K + 1] (B, N): K means a
    new cluster, K + 1 a dropped point (out of the grid, or its cell's bank
    is full). cell: (B, N) flat cell index, clamped into the grid."""
    B, H, W, K = grid.num_pts.shape
    at = cell[..., None].expand(*cell.shape, K)

    def rows(a):
        return torch.gather(a.reshape(B, H * W, K), 1, at)
    means_z, var, num = (rows(grid.mean[..., 2]), rows(grid.var_z),
                         rows(grid.num_pts))
    dist = (means_z - z[..., None]).abs()
    initialized = num >= cfg.min_cluster_points
    gate = torch.sqrt(torch.clamp(var, min=0.0)) * \
        cfg.cluster_sigma_factor + cfg.cluster_dist_threshold
    in_gate = initialized & (dist < gate) & (num > 0)
    first_init, any_init = _first_true(in_gate)
    uninit = (num > 0) & ~initialized
    d_un = torch.where(uninit, dist, float("inf"))
    near_un = d_un.argmin(-1)
    un_ok = torch.gather(d_un, -1, near_un[..., None])[..., 0] < \
        cfg.robot_height
    has_empty = (num <= 0).any(-1)
    slot = torch.where(any_init, first_init, torch.where(
        un_ok, near_un, torch.where(has_empty, K, K + 1)))
    return torch.where(inb, slot, K + 1)


def add_to_mls(grid: MlsGrid, cloud: PointCloud, cfg) -> MlsGrid:
    """Fold clouds (B, N), robot-centred (or world-frame for a grid centred
    on the origin), into the cluster grids and refresh the drivability of
    the cells they touch. Split by rows, the points of the slab's rows."""
    B, H, W, K = grid.num_pts.shape
    xyz = cloud.xyz
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    N = x.shape[1]
    cx = torch.floor(true_div(x, cfg.resolution)).to(torch.int32) + \
        whole_rows(grid.rows, H) // 2
    cy = torch.floor(true_div(y, cfg.resolution)).to(torch.int32) + W // 2
    if grid.rows is not None:
        cx = cx - grid.rows.r0
    rng = torch.sqrt(x * x + y * y)
    inb = cloud.valid & (cx >= 0) & (cy >= 0) & (cx < H) & (cy < W) & \
        (rng <= cfg.max_range)
    cell = (cx.clamp(0, H - 1) * W + cy.clamp(0, W - 1)).long()
    slot = _associate(grid, cell, z, inb, cfg)

    # Phase B: per-(cell, slot) sums; slot K collects a new cluster's
    # points, K + 1 the dropped ones. A point outside the grid adds zeros
    # to a slot of its own robot's grid, spread by index (one spare slot
    # for all of them would serialize the card's atomics on one address).
    S = H * W * (K + 2)
    spread = torch.arange(N, device=x.device) % S
    flat = (torch.arange(B, device=x.device)[:, None] * S +
            torch.where(inb, cell * (K + 2) + slot, spread)).reshape(-1)
    vals = torch.stack([torch.ones_like(x), x, y, z, z * z], -1)
    vals = torch.where(inb[..., None], vals, 0.0)
    acc = torch.zeros(B * S, 5, dtype=xyz.dtype, device=x.device)
    acc.index_add_(0, flat, vals.reshape(-1, 5))
    acc = acc.view(B, H, W, K + 2, 5)
    cnt, sx, sy, sz, szz = acc.unbind(-1)
    c_exist = cnt[..., :K]
    c_new = cnt[..., K]

    # Phase C1: merge the batch stats into existing clusters (Chan's
    # parallel merge)
    n0 = grid.num_pts
    mean0 = grid.mean
    mean_z0 = mean0[..., 2]
    n1 = torch.clamp(n0 + c_exist, max=cfg.max_cluster_points)
    tot = torch.clamp(n0 + c_exist, min=1e-9)
    ce = torch.clamp(c_exist, min=1e-9)
    bm_x, bm_y, bm_z = sx[..., :K] / ce, sy[..., :K] / ce, sz[..., :K] / ce
    f = c_exist / tot
    upd = c_exist > 0

    def blend(m0, bm):
        return torch.where(upd, m0 * (1 - f) + bm * f, m0)
    mean_x, mean_y = blend(mean0[..., 0], bm_x), blend(mean0[..., 1], bm_y)
    mean_z = blend(mean_z0, bm_z)
    b_var = torch.clamp(szz[..., :K] / ce - bm_z * bm_z, min=0.0)
    dz = bm_z - mean_z0
    var_m = (n0 * grid.var_z + c_exist * b_var) / tot + \
        (n0 * c_exist) / (tot * tot) * (dz * dz)
    var_z = torch.where(upd & (n1 > 1),
                        torch.clamp(var_m, min=cfg.min_var_z), grid.var_z)
    num = torch.where(upd, n1, n0)

    # Phase C2: one new cluster per cell from its unmatched points, in the
    # first empty slot of the bank as it was (none when it was full)
    e_idx, e_any = _first_true(n0 <= 0)
    put = _onehot(e_idx, e_any & (c_new > 0), K)
    cn = torch.clamp(c_new, min=1e-9)
    nm_x, nm_y, nm_z = sx[..., K] / cn, sy[..., K] / cn, sz[..., K] / cn
    nv = torch.clamp(szz[..., K] / cn - nm_z * nm_z, min=cfg.min_var_z)
    mean_x = torch.where(put, nm_x[..., None], mean_x)
    mean_y = torch.where(put, nm_y[..., None], mean_y)
    mean_z = torch.where(put, nm_z[..., None], mean_z)
    var_z = torch.where(put, nv[..., None], var_z)
    num = torch.where(put, torch.clamp(c_new, max=cfg.max_cluster_points
                                       )[..., None], num)

    mean_x, mean_y, mean_z, var_z, num = _sort_k(
        torch.where(num > 0, mean_z, float("inf")),
        (mean_x, mean_y, mean_z, var_z, num))

    # ground-pair merge: the ground cluster (first initialized) absorbs the
    # next slot when that one is initialized and the clearance between them
    # is below cluster_combine_dist
    g, has_g = _first_true(num >= cfg.min_cluster_points)
    n_ok = has_g & (g + 1 < K)
    num_g, num_n = _pick(num, g, has_g), _pick(num, g + 1, n_ok)
    next_ok = n_ok & (num_n >= cfg.min_cluster_points)
    clearance = _pick(mean_z, g + 1, n_ok) - \
        torch.sqrt(torch.clamp(_pick(var_z, g + 1, n_ok), min=0.0)) * 2 - \
        _pick(mean_z, g, has_g)
    do_merge = next_ok & (clearance < cfg.cluster_combine_dist)
    ntot = torch.clamp(num_g + num_n, min=1e-9)
    r0, r1 = num_g / ntot, num_n / ntot
    mg = _onehot(g, do_merge, K)
    mn = _onehot(g + 1, do_merge, K)

    def merge(a):
        return torch.where(mg, (r0 * _pick(a, g, has_g) +
                                r1 * _pick(a, g + 1, n_ok))[..., None], a)
    mean_x, mean_y, mean_z, var_z = map(merge, (mean_x, mean_y, mean_z,
                                                var_z))
    num = torch.where(mg, torch.clamp(num_g + num_n,
                                      max=cfg.max_cluster_points)[..., None],
                      num)
    num = torch.where(mn, 0.0, num)
    mean_x, mean_y, mean_z, var_z, num = _sort_k(
        torch.where(num > 0, mean_z, float("inf")),
        (mean_x, mean_y, mean_z, var_z, num))

    grid = grid.replace(mean=torch.stack([mean_x, mean_y, mean_z], -1),
                        var_z=var_z, num_pts=num)
    touched = cnt.sum(-1) > 0
    return grid.replace(drivable=_drivability(grid, touched, cfg))


def _drivability(grid: MlsGrid, touched: torch.Tensor,
                 cfg) -> torch.Tensor:
    """One synchronous pass of the drivability chain over the touched cells
    that hold an initialized cluster: blocked by an initialized cluster
    too close above the ground cluster, by a neighbour's initialized slot 0
    lower than this cell's slot 0 by more than height_threshold, or by a
    ground variance above normal_threshold; other cells keep their flag."""
    K = grid.num_pts.shape[-1]
    num, mean_z, var_z = grid.num_pts, grid.mean[..., 2], grid.var_z
    g, has_g = _first_true(num >= cfg.min_cluster_points)
    ground_z = _pick(mean_z, g, has_g)
    ground_var = _pick(var_z, g, has_g)
    n_ok = has_g & (g + 1 < K)
    next_ok = n_ok & (_pick(num, g + 1, n_ok) >= cfg.min_cluster_points)
    clearance = _pick(mean_z, g + 1, n_ok) - \
        torch.sqrt(torch.clamp(_pick(var_z, g + 1, n_ok), min=0.0)) * 2 - \
        ground_z
    blocked_intra = next_ok & (clearance < cfg.drive_dist_threshold)

    # the cell's slot 0 (whatever its count) against the neighbours'
    # initialized slot 0
    z0 = mean_z[..., 0]
    H, W = z0.shape[1:]
    z0_init = torch.where(num[..., 0] >= cfg.min_cluster_points, z0,
                          float("inf"))
    if grid.rows is None:
        pz = F.pad(z0_init, (1, 1, 1, 1), value=float("inf"))
    else:
        pz = F.pad(halo(z0_init, 1, float("inf"), grid.rows), (1, 1, 0, 0),
                   value=float("inf"))
    max_diff = None
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            nz = pz[:, 1 + di: 1 + di + H, 1 + dj: 1 + dj + W]
            d = torch.where(torch.isfinite(nz), z0 - nz, float("-inf"))
            max_diff = d if max_diff is None else torch.maximum(max_diff, d)
    blocked_nbr = (num[..., 0] > 0) & (max_diff > cfg.height_threshold)
    blocked_var = ground_var.abs() > cfg.normal_threshold
    blocked = blocked_intra | blocked_nbr | blocked_var
    return torch.where(has_g & touched, (~blocked).to(torch.int8),
                       grid.drivable)


def offset_mls_z(grid: MlsGrid, dz: torch.Tensor) -> MlsGrid:
    """Shift every existing cluster's mean z by dz (B,) (a graph pose
    offset's z); empty slots keep mean 0, and variances, counts and
    drivability stay."""
    exists = grid.num_pts > 0
    z = grid.mean[..., 2] + torch.where(exists, dz[:, None, None, None], 0.0)
    return grid.replace(mean=torch.cat([grid.mean[..., :2], z[..., None]],
                                       -1))


def get_segmented_clouds(grid: MlsGrid, cfg, capacity: int):
    """Cluster means as (obstacle, ground) clouds of `capacity` points each:
    the ground cluster of a drivable cell is ground, every other initialized
    cluster an obstacle; each cloud takes the most populated clusters, ties
    to the lower (cell, slot) index (a stable descending sort: the order
    jax.lax.top_k gives), in the frame the grid's clouds were given in.
    Split by rows, the whole grid's clusters on every rank of the sp
    group."""
    B, H, W, K = grid.num_pts.shape
    num = grid.num_pts
    initialized = num >= cfg.min_cluster_points
    gidx, _ = _first_true(initialized)
    is_ground = initialized & (torch.arange(K, device=num.device) ==
                               gidx[..., None]) & (grid.drivable == 1)[..., None]
    is_obstacle = initialized & ~is_ground
    xyz = grid.mean.reshape(B, H * W * K, 3)

    def top(mask):
        score = torch.where(mask, num, -1.0).reshape(B, -1)
        v, idx = torch.sort(score, dim=-1, descending=True, stable=True)
        v, idx = v[:, :capacity], idx[:, :capacity]
        pts = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
        if grid.rows is not None:
            v, (pts,) = merge_top(v, [pts], capacity, grid.rows)
        sel = v > 0
        return PointCloud(xyz=torch.where(sel[..., None], pts, 0.0),
                          valid=sel,
                          flags=torch.zeros(B, capacity, dtype=torch.int32,
                                            device=num.device))
    return top(is_obstacle), top(is_ground)
