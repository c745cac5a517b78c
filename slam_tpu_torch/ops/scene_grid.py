"""Reference-scale scene build — counterpart of slam_tpu/ops/scene_grid.py
(`build_scene_grid_planes`), batched over robots.

One scatter of the scan into a robot-centred grid of per-cell centroid
sums replaces the (N, N) same-cell incidence of the small-scan builder,
which is O(N^2) at the reference's >= 20k-point scans. Ground adjacency is
the occupancy stencil's rule; the exported points are the `capacity` most
observed cells, equal counts to the lower flat cell index (the order of
slam_tpu's top-k), fixed by one stable descending sort as
mapping/point_map.py's export does.
"""

from __future__ import annotations

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.ops.scatter2d import gather_cells_2d, scatter_add_2d_multi
from slam_tpu_torch.ops.stencil import neighbor_sum_2d


def build_scene_grid_planes(px, py, pz, valid, drv, capacity: int,
                            resolution: float, grid_bins: int,
                            ga_threshold: int, min_count: float = 1.0):
    """Voxelize robot-frame scans (B, N) into scene planes (B, capacity).

    pz: z plane or None (2D); drv: drivable-over plane (f32 0/1) or None.
    Returns (sx, sy, sz, ga, drv_out, keep); sz / drv_out are None when
    their input is. Points beyond the grid's half-extent are dropped."""
    G = grid_bins
    ci = torch.floor(true_div(px, resolution)).to(torch.int32) + G // 2
    cj = torch.floor(true_div(py, resolution)).to(torch.int32) + G // 2
    inb = valid & (ci >= 0) & (cj >= 0) & (ci < G) & (cj < G)
    cci = ci.clamp(0, G - 1)
    ccj = cj.clamp(0, G - 1)
    ox = px - (cci.to(px.dtype) - G // 2 + 0.5) * resolution
    oy = py - (ccj.to(py.dtype) - G // 2 + 0.5) * resolution
    chans = [None, ox, oy] + [c for c in (pz, drv) if c is not None]
    accs = list(scatter_add_2d_multi(cci, ccj, tuple(chans), inb, (G, G)))
    count = accs[0]

    occ = count >= min_count
    box = neighbor_sum_2d((~occ).to(torch.float32))
    ii = torch.arange(G, device=px.device)
    inner = (ii > 0) & (ii < G - 1)
    ga = occ & (inner[:, None] & inner[None, :]) & (box >= ga_threshold)

    B = count.shape[0]
    score = torch.where(occ, count, 0.0).reshape(B, -1)
    v, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    v, idx = v[:, :capacity], idx[:, :capacity]
    sel = v >= min_count
    si = idx // G
    sj = idx % G
    out = gather_cells_2d(tuple(accs[:3]) + (ga.to(torch.float32),) +
                          tuple(accs[3:]), si, sj)
    cnt = torch.clamp(out[0], min=1.0)
    sx = torch.where(sel, (si - G // 2 + 0.5) * resolution + out[1] / cnt,
                     0.0)
    sy = torch.where(sel, (sj - G // 2 + 0.5) * resolution + out[2] / cnt,
                     0.0)
    ga_pt = sel & (out[3] > 0.5)
    k = 4
    sz = drv_out = None
    if pz is not None:
        sz = torch.where(sel, out[k] / cnt, 0.0)
        k += 1
    if drv is not None:
        drv_out = sel & (out[k] > 0.5)
    return sx, sy, sz, ga_pt, drv_out, sel
