"""Plain reference of the 3D Velodyne SLAM tick and macro, in PyTorch.

The 3D counterpart of slam2d.py (whose EKF, ICP, grids and state layout
it shares): a terrain of sines with cylinders, a tilted ring scan, IMU
roll / pitch compensation, GP-INSAC ground segmentation, the obstacle
scene voxelised on a scan-local grid, class-constrained ICP against the
exported obstacle map, the wheel-contact height off the ground grid, and
obstacle, ground and occupancy grids. It imports nothing of the program.

The state is slam2d's dict, with pose (B, 4) carrying z, the ground map
gm_count, gm_sx, gm_sy, gm_sz (B, G, G), gm_center (B, 2), and the last
scene's scene_z and scene_drv.
"""

from __future__ import annotations

import math

import torch

from . import slam2d as r2
from .slam2d import div, mm, place

# ---------------------------------------------------------------- world


def make_world(gen, sim, device, terrain_amp=0.6, num_waves=4):
    """Cylinders where the 2D world puts its obstacles, heights uniform in
    [0.5, 3], on `num_waves` sines of frequencies uniform in [0.02, 0.08],
    phases spread over [0, 3] and amplitude terrain_amp / num_waves.
    Returns (centres, radii, heights, terrain (K, 4), extent)."""
    pos, radii, extent = r2.make_world(gen, sim, device)
    M = sim["num_obstacles"]
    heights = 0.5 + 2.5 * torch.rand(M, generator=gen, device=device)
    freq = 0.02 + 0.06 * torch.rand(num_waves, 2, generator=gen,
                                    device=device)
    phase = torch.linspace(0.0, 3.0, num_waves, device=device)[:, None]
    amp = torch.full((num_waves, 1), terrain_amp / num_waves, device=device)
    return pos, radii, heights, torch.cat([freq, phase, amp], -1), extent


def terrain(world, xy):
    t = world[3]
    arg = xy[..., 0:1] * t[:, 0] + xy[..., 1:2] * t[:, 1] + t[:, 2]
    return (t[:, 3] * torch.sin(arg)).sum(-1)


def attitude(world, xy, eps=0.25):
    """(roll, pitch) resting on the terrain at xy (B, 2): central
    differences of the height over +-eps."""
    ex = torch.tensor([eps, 0.0], device=xy.device)
    ey = torch.tensor([0.0, eps], device=xy.device)
    gx = (terrain(world, xy + ex) - terrain(world, xy - ex)) / (2 * eps)
    gy = (terrain(world, xy + ey) - terrain(world, xy - ey)) / (2 * eps)
    return torch.atan(gy), -torch.atan(gx)


def rot3(roll, pitch, yaw):
    """R = Rz(yaw) Ry(pitch) Rx(roll), (..., 3, 3)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def ray_directions(sim, device):
    """(R * A, 3) unit beam directions, ring-major."""
    elev = torch.linspace(sim["ring_elevation_min"], sim["ring_elevation_max"],
                          sim["num_rings"], device=device)
    az = torch.arange(sim["num_azimuth"], device=device) * \
        (2 * math.pi / sim["num_azimuth"])
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    x = ce * torch.cos(az)[None]
    return torch.stack([x, ce * torch.sin(az)[None],
                        torch.broadcast_to(se, x.shape)], -1).reshape(-1, 3)


def raycast(world, pose, sim, roll, pitch, noise=None, march=16, refine=5):
    """Points (B, N, 3) in the tilted sensor frame and hits (B, N) of the
    ring scan from sensors sensor_height above the terrain under poses
    (B, 3): the first terrain crossing (bracketed by a march of `march`
    steps to beam_max_range, refined by `refine` regula falsi steps), or
    the nearest cylinder wall within its height."""
    centers, radii, heights = world[0], world[1], world[2]
    o = torch.stack([pose[:, 0], pose[:, 1],
                     terrain(world, pose[:, :2]) + sim["sensor_height"]], -1)
    dl = ray_directions(sim, pose.device)
    d = mm(rot3(roll, pitch, pose[:, 2]), dl.T).mT              # (B, N, 3)
    tmax = sim["beam_max_range"]
    ts = torch.linspace(0.0, tmax, march, device=pose.device)
    pts = o[:, None, None, :] + ts[:, None] * d[:, :, None, :]
    marg = pts[..., 2] - terrain(world, pts[..., :2])
    above = marg > 0
    crossed = above[..., :-1] & ~above[..., 1:]
    has = crossed.any(-1)
    k = torch.argmax(crossed.to(torch.int8), -1, keepdim=True)
    lo = ts[:-1][k[..., 0]]
    hi = ts[1:][k[..., 0]]
    m_lo = torch.gather(marg[..., :-1], -1, k)[..., 0]
    m_hi = torch.gather(marg[..., 1:], -1, k)[..., 0]
    for _ in range(refine):
        mid = lo + (hi - lo) * m_lo / torch.clamp(m_lo - m_hi, min=1e-12)
        p = o[:, None, :] + mid[..., None] * d
        m_mid = p[..., 2] - terrain(world, p[..., :2])
        up = m_mid > 0
        lo, m_lo = torch.where(up, mid, lo), torch.where(up, m_mid, m_lo)
        hi, m_hi = torch.where(up, hi, mid), torch.where(up, m_hi, m_mid)
    t_terr = torch.where(
        has, lo + (hi - lo) * m_lo / torch.clamp(m_lo - m_hi, min=1e-12),
        float("inf"))
    oc = o[:, None, :2] - centers
    dxy = d[..., :2]
    a = (dxy * dxy).sum(-1)[..., None]
    b = mm(dxy, oc.mT)
    c = (oc * oc).sum(-1)[:, None, :] - radii ** 2
    disc = b * b - a * c
    tc = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(a, min=1e-9)
    pz = o[:, None, 2:3] + tc * d[..., 2:3]
    g = terrain(world, centers)
    tc = torch.where((disc > 0) & (tc > 1e-3) & (pz > g) & (pz < g + heights),
                     tc, float("inf")).amin(-1)
    t = torch.minimum(t_terr, tc)
    hit = torch.isfinite(t) & (t < tmax)
    t = torch.where(hit, t, tmax)
    if noise is not None:
        t = t + sim["range_noise"] * noise
    return t[..., None] * dl, hit


# ----------------------------------------------------------- ground seg

def segment_ground(x, y, z, valid, g):
    """GP-INSAC on upright scans (B, N): polar bins (sectors x range
    bins); a bin's prototype is its lowest point (z to the mm, the first
    in scan order among equals); per sector the bins holding more than
    min_bin_points points, by prototype height, the lowest
    signal_capacity of them, are the signal; up to num_seed_points lowest
    signal bins within the seed range and height seed the model; each
    sweep regresses a squared-exponential GP on the model and adopts every
    signal bin it predicts within the confidences; then a point of a model
    bin is ground within ground_threshold of its prototype, else an
    obstacle, and a point of another signal bin is an obstacle where its
    sector had two seeds; an obstacle more than robot_height above its
    reference height is drivable-over. Returns (ground, obstacle,
    drivable) masks (B, N)."""
    S, L, C = g["num_sectors"], g["num_range_bins"], g["signal_capacity"]
    K = S * L
    B, N = x.shape
    dev = x.device
    r3 = torch.sqrt(x * x + y * y + z * z)
    r2d = torch.sqrt(x * x + y * y)
    phi = torch.atan2(y, x) * (180.0 / math.pi)
    phi = torch.where(phi < 0, phi + 360.0, phi)
    sector = torch.clamp(div(phi, 360.0 / S).long(), 0, S - 1)
    lbin = div(r2d, g["r_max"] / L).long()
    ok = valid & (r3 < g["r_max"]) & (lbin >= 0) & (lbin < L)
    flat = torch.where(ok, sector * L + lbin, K)
    zq = torch.clamp(torch.round((z + 500.0) * 1000.0), 0, 2 ** 20 - 2).long()
    rows = torch.arange(B, device=dev)[:, None]
    count = torch.zeros(B, K + 1, device=dev).index_put_(
        (rows.expand(B, N), flat), torch.ones(B, N, device=dev),
        accumulate=True)[:, :K]
    lowest = torch.full((B, K + 1), 2 ** 40, dtype=torch.long, device=dev)
    lowest.scatter_reduce_(1, flat, zq, "amin")
    pos = torch.arange(N, device=dev).expand(B, N)
    at_low = torch.gather(lowest, 1, flat) == zq
    first = torch.full((B, K + 1), N, dtype=torch.long, device=dev)
    first.scatter_reduce_(1, flat, torch.where(at_low, pos, N), "amin")
    first = first[:, :K].clamp(max=N - 1)
    held = count > 0                                     # empty bins read 0
    proto_r = torch.where(held, torch.gather(r2d, 1, first), 0.0).view(B, S, L)
    proto_h = torch.where(held, torch.gather(z, 1, first), 0.0).view(B, S, L)
    sig = (count > g["min_bin_points"]).view(B, S, L)
    order = torch.argsort(torch.where(sig, proto_h, float("inf")), dim=-1,
                          stable=True)[..., :C]
    h = torch.gather(proto_h, -1, order)
    r = torch.gather(proto_r, -1, order)
    sv = torch.gather(sig, -1, order)
    qual = sv & (r < g["seed_max_range"]) & (h.abs() < g["seed_max_height"])
    npt = torch.clamp(sv.sum(-1), max=g["num_seed_points"])
    seed = qual & (torch.cumsum(qual.long(), -1) <= npt[..., None])
    enough = seed.sum(-1) >= 2
    d = r[..., :, None] - r[..., None, :]
    Kxx = g["gp_signal_var"] * torch.exp(-(d * d) /
                                         (2.0 * g["gp_length_scale"] ** 2))
    eye = torch.eye(C, device=dev)
    m = seed
    active = enough & (sv & ~seed).any(-1)
    f_s = torch.zeros_like(h)
    for _ in range(g["max_insac_sweeps"]):
        mf = m.float()
        # the GP on the model bins; the others are decoupled unit rows
        M = Kxx * mf[..., :, None] * mf[..., None, :] + \
            eye * (g["gp_noise"] * mf + (1.0 - mf))[..., None, :]
        Kcm = Kxx * mf[..., None, :]                     # (c, model j)
        Lc = torch.linalg.cholesky(M)
        alpha = torch.cholesky_solve((h * mf)[..., None], Lc)
        f = mm(Kcm, alpha)[..., 0]
        X = torch.cholesky_solve(Kcm.mT, Lc)             # M^-1 Kmc
        v = g["gp_signal_var"] - (Kcm.mT * X).sum(-2)
        met = (h - f) / torch.sqrt(g["gp_noise"] + v * v)
        inl = sv & ~m & (v < g["gp_model_confidence"]) & \
            (met.abs() < g["gp_data_confidence"]) & active[..., None]
        m = m | inl
        f_s = torch.where(active[..., None], f, f_s)
        active = active & inl.any(-1) & (sv & ~m).any(-1)

    def to_bins(v):
        return torch.zeros(B, S, L, device=dev).scatter_(-1, order, v.float())
    table = torch.stack([to_bins(sv), to_bins(m & sv), proto_h,
                         to_bins(torch.where(sv, f_s, 0.0)),
                         enough[..., None].expand(B, S, L).float()], -1)
    table = torch.cat([table.reshape(B, K, 5), torch.zeros(B, 1, 5,
                                                           device=dev)], 1)
    p = torch.gather(table, 1, flat[..., None].expand(B, N, 5))
    p_sig = ok & (p[..., 0] > 0.5)
    p_model = p[..., 1] > 0.5
    h_model = (p[..., 2] - z).abs()
    ground = p_sig & p_model & (h_model < g["ground_threshold"])
    obstacle = (p_sig & p_model & ~ground) | (p_sig & ~p_model &
                                              (p[..., 4] > 0.5))
    h_ref = torch.where(p_model, h_model, (z - p[..., 3]).abs())
    return ground, obstacle, obstacle & (h_ref > g["robot_height"])


# ---------------------------------------------------------------- scene

def scene_grid(px, py, pz, keep, drv, cap, res, G, ga_threshold):
    """The obstacle scene on a robot-centred grid of G x G cells: per-cell
    centroid sums, the `cap` most observed cells (equal counts in flat
    cell order), GA as in slam2d, drivable where any point of the cell
    is. Returns (x, y, z, valid, ga, drv) of `cap` slots."""
    B = px.shape[0]
    ci = torch.floor(div(px, res)).long() + G // 2
    cj = torch.floor(div(py, res)).long() + G // 2
    inb = keep & (ci >= 0) & (cj >= 0) & (ci < G) & (cj < G)
    ci, cj = ci.clamp(0, G - 1), cj.clamp(0, G - 1)
    ox = px - (ci.float() - G // 2 + 0.5) * res
    oy = py - (cj.float() - G // 2 + 0.5) * res
    n = r2.cell_sum(ci, cj, None, inb, G, G)
    sums = [r2.cell_sum(ci, cj, v, inb, G, G) for v in (ox, oy, pz, drv)]
    occ = n >= 1.0
    ga = occ & r2.interior(G, G, px.device) & \
        (r2.empty_neighbours(occ) >= ga_threshold)
    v, idx = torch.sort(torch.where(occ, n, 0.0).reshape(B, -1), dim=-1,
                        descending=True, stable=True)
    v, idx = v[:, :cap], idx[:, :cap]
    sel = v >= 1.0

    def read(a):
        return torch.gather(a.reshape(B, -1), 1, idx)
    cnt = read(n).clamp(min=1.0)
    si, sj = idx // G, idx % G
    x = torch.where(sel, (si - G // 2 + 0.5) * res + read(sums[0]) / cnt, 0.0)
    y = torch.where(sel, (sj - G // 2 + 0.5) * res + read(sums[1]) / cnt, 0.0)
    zz = torch.where(sel, read(sums[2]) / cnt, 0.0)
    return (x, y, zz, sel, sel & (read(ga.float()) > 0.5),
            sel & (read(sums[3]) > 0.5))


# --------------------------------------------------------------- height

def plane_normal(pts, w):
    """Unit normals (B, 3), z up, of the weighted best-fit planes through
    pts (B, 4, 3): the scatter's smallest eigenvector; vertical where the
    middle eigenvalue is below 1e-6 (the points are collinear). Also
    (B,) near-ties: the middle eigenvalue, or the gap between the two
    smallest, below 1e-5 of the largest (at least 1): the matches are
    nearly collinear, the normal ill-determined, and the program's
    closed form in float32 may fall back, or take another vector, where
    this one does not."""
    ws = torch.clamp(w.sum(-1), min=1e-9)
    mu = (w[..., None] * pts).sum(-2) / ws[..., None]
    dd = (pts - mu[:, None]) * w[..., None]
    Smat = mm(dd.mT, dd)
    lam, vec = torch.linalg.eigh(Smat.double())
    n = vec[..., 0].float()
    up = torch.tensor([0.0, 0.0, 1.0], device=pts.device)
    n = torch.where((lam[:, 1] < 1e-6)[:, None], up, n)
    scale = lam[:, 2].clamp(min=1.0)
    near = (lam[:, 1] < 1e-5 * scale) | (lam[:, 1] - lam[:, 0] < 1e-5 * scale)
    return torch.where(n[:, 2:3] < 0, -n, n), near


def height_planes(gx, gy, gz, gvalid, pose, h):
    """New z (B,) from world ground points (B, N) under poses (B, 4): each
    of four wheel points (+-x_wheel_dist, +-y_wheel_dist) takes its
    nearest valid ground point (the first of equals) within
    max_nn_dist_sq; with at least min_corr_points matches the robot
    stands robot_height along the matches' plane normal above their mean
    height, else it keeps its z. Returns (z, near-ties: a wheel's nearest
    point at the gate or tied, or the plane's normal ill-determined; the
    last of these alone)."""
    x, y, yaw, z0 = pose.unbind(-1)
    xw, yw = h["x_wheel_dist"], h["y_wheel_dist"]
    wl = torch.tensor([[-xw, -yw], [-xw, yw], [xw, -yw], [xw, yw]],
                      device=gx.device)
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    wx = wl[:, 0] * c - wl[:, 1] * s + x[:, None]
    wy = wl[:, 0] * s + wl[:, 1] * c + y[:, None]
    wz = z0 - h["robot_height"]
    d2 = (wx[..., None] - gx[:, None]) ** 2 + (wy[..., None] - gy[:, None]) \
        ** 2 + (wz[:, None, None] - gz[:, None]) ** 2
    d2 = torch.where(gvalid[:, None], d2, 1e30)
    dmin, k = d2.min(-1)
    corr = torch.stack([torch.gather(a, 1, k) for a in (gx, gy, gz)], -1)
    ok = dmin < h["max_nn_dist_sq"]
    w = ok.float()
    avg = (w[..., None] * corr).sum(-2) / torch.clamp(w.sum(-1),
                                                      min=1e-9)[:, None]
    n, near = plane_normal(corr, w)
    good = (ok.sum(-1) >= h["min_corr_points"]) & torch.isfinite(n).all(-1)
    # a wheel's nearest ground point at the gate, or tied with the next
    above = torch.where(d2 > dmin[..., None], d2, float("inf")).amin(-1)
    plane = good & near
    near = plane | ((dmin - h["max_nn_dist_sq"]).abs() < r2.NEAR).any(-1) | \
        ((above - dmin < r2.NEAR) & ok).any(-1)
    return (torch.where(good, n[:, 2] * h["robot_height"] + avg[:, 2], z0),
            near, plane)


def height_grid(st, pose, h, res):
    """height_planes over the occupied cells' centroids of the ground
    grid's window that any accepted match must lie in: (z, near-ties,
    the plane's alone)."""
    G = st["gm_count"].shape[-1]
    reach = math.hypot(h["x_wheel_dist"], h["y_wheel_dist"])
    half = int(math.ceil((math.sqrt(h["max_nn_dist_sq"]) + reach) / res)) + 1
    W = min(2 * half + 1, G)
    rel = pose[:, :2] - st["gm_center"]
    ci = torch.floor(div(rel[:, 0], res)).long() + G // 2
    cj = torch.floor(div(rel[:, 1], res)).long() + G // 2
    i0 = torch.clamp(ci - (W - 1) // 2, 0, G - W)
    j0 = torch.clamp(cj - (W - 1) // 2, 0, G - W)
    ar = torch.arange(W, device=ci.device)
    ii = (i0[:, None] + ar)[:, :, None].expand(-1, W, W).reshape(-1, W * W)
    jj = (j0[:, None] + ar)[:, None, :].expand(-1, W, W).reshape(-1, W * W)
    n, sx, sy, sz = (r2.cell_read(st[k], ii, jj) for k in
                     ("gm_count", "gm_sx", "gm_sy", "gm_sz"))
    safe = n.clamp(min=1.0)
    cx = (ii.float() - G // 2 + 0.5) * res + st["gm_center"][:, :1]
    cy = (jj.float() - G // 2 + 0.5) * res + st["gm_center"][:, 1:]
    return height_planes(cx + sx / safe, cy + sy / safe, sz / safe, n >= 1.0,
                         pose, h)


# ----------------------------------------------------------------- maps

def grid_add(st, p, qx, qy, qz, valid, res):
    """Fold world points (B, N) into the grid of prefix p ("pm", "gm"),
    z summed absolutely."""
    G = st[p + "_count"].shape[-1]
    rx = qx - st[p + "_center"][:, :1]
    ry = qy - st[p + "_center"][:, 1:]
    cx = torch.floor(div(rx, res)).long() + G // 2
    cy = torch.floor(div(ry, res)).long() + G // 2
    ox = rx - (cx.float() - G // 2 + 0.5) * res
    oy = ry - (cy.float() - G // 2 + 0.5) * res
    for k, v in (("_count", None), ("_sx", ox), ("_sy", oy), ("_sz", qz)):
        st[p + k] = st[p + k] + r2.cell_sum(cx, cy, v, valid, G, G)


def shift_grid(st, p, xy, res):
    keys = [p + k for k in ("_count", "_sx", "_sy", "_sz")]
    st[p + "_center"], out = r2.shift(st[p + "_center"], xy, res,
                                      [st[k] for k in keys], (0.0,) * 4)
    st.update(zip(keys, out))


def occupancy_add2(st, ox, oy, ovalid, gx, gy, gvalid, mls):
    """+occupancy_increment an obstacle point, -occupancy_decrement a
    ground point, robot-centred and world-oriented planes."""
    H, W = st["occ_counts"].shape[1:]
    lx, ly = torch.cat([ox, gx], -1), torch.cat([oy, gy], -1)
    sign = torch.cat([torch.full_like(ox, mls["occupancy_increment"]),
                      torch.full_like(gx, -mls["occupancy_decrement"])], -1)
    cx = torch.floor(div(lx, mls["resolution"])).long() + mls["size_x"] // 2
    cy = torch.floor(div(ly, mls["resolution"])).long() + mls["size_y"] // 2
    keep = torch.cat([ovalid, gvalid], -1) & \
        (lx * lx + ly * ly <= mls["max_range"] ** 2)
    delta = r2.cell_sum(cx, cy, sign, keep, H, W)
    touch = r2.cell_sum(cx, cy, None, keep, H, W)
    counts = st["occ_counts"] + delta
    t = touch > 0
    st["occ_drivable"] = torch.where(
        t & (counts > mls["min_cluster_points"]), 0,
        torch.where(t & (counts < mls["min_cluster_points"]), 1,
                    st["occ_drivable"])).to(torch.int8)
    st["occ_counts"] = counts


# ------------------------------------------------------------------ ICP

def icp_compact(sx, sy, sv, sga, mx, my, mv, mga, pred, icp_cfg, block):
    """slam2d.icp_fused on the valid points only, packed to the front in
    order, `block` robots at a time."""
    def pack(x, y, v, ga):
        order = torch.argsort((~v).to(torch.int8), dim=-1, stable=True)
        n = int(v.sum(-1).max().clamp(min=1))
        order = order[:, :n]
        return [torch.gather(a, 1, order) for a in (x, y, v, ga)]
    S = pack(sx, sy, sv, sga)
    M = pack(mx, my, mv, mga)
    outs = []
    for b0 in range(0, sx.shape[0], block):
        sl = slice(b0, b0 + block)
        outs.append(r2.icp_fused(*[a[sl] for a in S], *[a[sl] for a in M],
                                 pred[sl], icp_cfg))
    return tuple(torch.cat(o) for o in zip(*outs))


# ----------------------------------------------------------- tick, macro

def init_state(gen, world, cfg, batch, device):
    st = r2.init_state(gen, cfg, batch, device)
    z0 = terrain(world, torch.zeros(2, device=device)) + \
        cfg["sim"]["sensor_height"]
    G = cfg["mls"]["size_x"]
    for k in ("pose", "true_pose"):
        st[k] = st[k].clone()
        st[k][:, 3] = z0
    zg = torch.zeros(batch, G, G, device=device)
    st.update(gm_count=zg, gm_sx=zg.clone(), gm_sy=zg.clone(),
              gm_sz=zg.clone(), gm_center=torch.zeros(batch, 2, device=device),
              scene_z=torch.zeros_like(st["scene_x"]),
              scene_drv=st["scene_valid"].clone())
    return st


def tick(st, world, cfg, gen, block=16):
    """One simulated 3D tick against the exported target: drive on the
    terrain, sense (range noise (B, N), then IMU noise (B, 3) from
    `gen`), compensate roll and pitch, EKF predict and gyro update,
    segment the ground, build the obstacle scene, register (ties
    averaged), EKF SLAM update, the wheel-contact height (off the ground
    grid once it holds min_corr_points cells, else off this scan's ground
    at the pose), then the obstacle and ground grids and the occupancy."""
    sim, e, icp_cfg, mls = cfg["sim"], cfg["ekf"], cfg["icp"], cfg["mls"]
    hcfg, cl = cfg["height"], cfg["cloud"]
    dt = sim["dt"]
    st = dict(st)
    cmd = r2.clamp_cmd(r2.drive_cmd(st["step"], dt), e)
    true = r2.unicycle(st["true_pose"][:, :3], cmd, dt)
    true_z = terrain(world, true[:, :2]) + sim["sensor_height"]
    roll, pitch = attitude(world, true[:, :2])
    B = true.shape[0]
    N = sim["num_rings"] * sim["num_azimuth"]
    noise = torch.randn((B, N), generator=gen, device=true.device)
    scan, hit = raycast(world, true, sim, roll, pitch, noise)
    imu = sim["gyro_noise"] * torch.randn(true.shape, generator=gen,
                                          device=true.device)
    gyro = cmd[:, 2] + sim["gyro_bias"] + imu[:, 2]
    roll = roll + imu[:, 0]
    pitch = pitch + imu[:, 1] + sim["imu_pitch_bias"]

    hit = hit & torch.isfinite(scan).all(-1)
    if cl["min_scan_points"] > 0:
        hit = hit & (hit.sum(-1, keepdim=True) >= cl["min_scan_points"])
    R = rot3(roll, pitch, torch.zeros_like(roll))
    xyz = mm(torch.where(hit[..., None], scan, 0.0), R.mT)
    x, y, z = xyz.unbind(-1)
    mu, sigma = r2.ekf_predict(st["mu"], st["sigma"], cmd, dt, e)
    mu, sigma = r2.ekf_gyro(mu, sigma, gyro, st["gyro_bias"], e)
    pred = r2.xyyaw(mu)
    ground, obstacle, drv = segment_ground(x, y, z, hit, cfg["ground"])
    ox, oy, oz, ov, oga, odrv = scene_grid(
        x, y, z, obstacle, drv.float(), cl["scene_capacity"],
        icp_cfg["ga_resolution"], icp_cfg["scan_grid_bins"],
        icp_cfg["ga_threshold"])
    d = icp_cfg["crop_dist"]
    mv = st["tgt_valid"] & ((st["tgt_x"] - pred[:, :1]).abs() <= d) & \
        ((st["tgt_y"] - pred[:, 1:2]).abs() <= d)
    pose, ok, _, _, near = icp_compact(ox, oy, ov, oga, st["tgt_x"],
                                       st["tgt_y"], mv, st["tgt_ga"], pred,
                                       icp_cfg, block)
    st["near"] = st.get("near", torch.zeros_like(ok)) | near
    mu, sigma = r2.ekf_slam(mu, sigma, pose, ok, e)
    fused = r2.xyyaw(mu)
    z_prev = st["pose"][:, 3:4]
    pose4_pre = torch.cat([fused, z_prev], -1)
    map_pose = torch.where(ok[:, None], pose, pred)
    res = icp_cfg["voxel_leaf_obs"][0]
    new_z, near_g, plane_g = height_grid(st, pose4_pre, hcfg, res)
    have_map = (st["gm_count"] >= 1.0).sum((1, 2)) >= hcfg["min_corr_points"]
    gwx, gwy = place(map_pose, x, y)
    z_scan, near_s, plane_s = height_planes(gwx, gwy, z + z_prev, ground,
                                            pose4_pre, hcfg)
    zz = torch.where(have_map, new_z, z_scan)[:, None]
    # near-ties of the height alone (z never feeds back into x, y or the
    # yaw); of them, the collinear-plane rule's apart, so that the check
    # can count them and what they would have read
    no = torch.zeros_like(ok)
    st["near_z"] = st.get("near_z", no) | torch.where(have_map, near_g,
                                                      near_s)
    st["near_plane"] = st.get("near_plane", no) | \
        torch.where(have_map, plane_g, plane_s)
    owx, owy = place(map_pose, ox, oy)
    grid_add(st, "pm", owx, owy, oz + zz, ov, res)
    grid_add(st, "gm", gwx, gwy, z + zz, ground, res)
    rel = torch.stack([fused[:, 0] - st["occ_center"][:, 0],
                       fused[:, 1] - st["occ_center"][:, 1], fused[:, 2]], -1)
    olx, oly = place(rel, ox, oy)
    glx, gly = place(rel, x, y)
    occupancy_add2(st, olx, oly, ov & ~odrv, glx, gly, ground, mls)
    st.update(mu=mu, sigma=sigma, pose=torch.cat([fused, zz], -1),
              reg_pose=torch.cat([map_pose, zz], -1), reg_ok=ok,
              scene_x=ox, scene_y=oy, scene_z=oz, scene_valid=ov,
              scene_ga=oga, scene_drv=odrv, step=st["step"] + 1,
              true_pose=torch.cat([true, true_z[:, None]], -1))
    return st


def macro(st, world, cfg, gen, ticks):
    """One 3D macro: re-centre the obstacle, occupancy and ground grids on
    the fused pose, export the registration target from the re-centred
    obstacle grid, then `ticks` ticks against it."""
    st = dict(st)
    res = cfg["icp"]["voxel_leaf_obs"][0]
    xy = st["pose"][:, :2]
    shift_grid(st, "pm", xy, res)
    r2.shift_occupancy(st, xy, cfg["mls"])
    shift_grid(st, "gm", xy, res)
    r2.point_map_export(st, cfg["cloud"]["map_capacity"], res,
                        cfg["icp"]["ga_threshold"])
    for _ in range(ticks):
        st = tick(st, world, cfg, gen)
    return st
