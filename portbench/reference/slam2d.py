"""Plain reference of the 2D lidar SLAM tick and macro, in PyTorch.

What the benchmark's 2D cells compare the program's outputs with. It
imports nothing of the program: the semantics are written out again from
the servos/SLAM stack as the program states them (an 8-state EKF, a
360-beam lidar raycast against circles and walls, a voxel scene with
ground-adjacency classes, class-constrained point-to-point ICP, a rolling
point-map grid exported as the registration target, and a rolling
occupancy grid). The nearest-point search is direct: every scene point
against every model point of its class, no kernel. Transforms, the Kabsch
cross-covariance, the raycast's projections and the EKF's products are
matrix products, so the control (the same code with TF32 on, the nearest
precision below the float32 the configurations state) departs from it
where a lower-precision program would.

A state is a dict of tensors with the robot batch first:
  mu (B, 8), sigma (B, 8, 8), gyro_bias (B,)  the EKF
  pose, true_pose (B, 4)                       fused and true x, y, yaw, z
  step (B,) int                                tick counter
  reg_pose (B, 4), reg_ok (B,)                 last registration
  occ_counts (B, H, W), occ_drivable (B, H, W) int8, occ_center (B, 2)
  pm_count, pm_sx, pm_sy, pm_sz (B, G, G), pm_center (B, 2)  point map
  scene_x, scene_y, scene_valid, scene_ga (B, cap)           last scene
  tgt_x, tgt_y, tgt_z, tgt_ga, tgt_valid (B, map_capacity)   exported map
`cfg` is a nested dict of the configuration file's values.
"""

from __future__ import annotations

import math

import torch

BIG = 1e30

# set by harness.checks.tf32: every matrix product of this module then
# rounds its operands to TF32 (10 mantissa bits, to nearest even) and
# accumulates in float32, as the card's TF32 tensor cores do, whatever
# cuBLAS would pick for a product this small
TF32 = [False]


def _tf32(x):
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def mm(a, b):
    """a @ b, in TF32 under the control."""
    if TF32[0]:
        return _tf32(a) @ _tf32(b)
    return a @ b


def div(x, d):
    """x / d as one true division (a 0-dim divisor), as a cell index needs."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def rot(yaw):
    """(..., 2, 2) rotations."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def place(pose, x, y):
    """Points (B, N) placed at poses (B, >=3): the 2 x 2 rotation's
    product written out, operand by operand (TF32 under the control)."""
    c = tf(torch.cos(pose[:, 2]))[:, None]
    s = tf(torch.sin(pose[:, 2]))[:, None]
    x, y = tf(x), tf(y)
    return c * x - s * y + pose[:, :1], s * x + c * y + pose[:, 1:2]


def place_mm(pose, x, y):
    """Points (B, N) placed at poses (B, >=3) as one matrix product."""
    q = mm(torch.stack([x, y], -1), rot(pose[:, 2]).mT) + pose[:, None, :2]
    return q[..., 0], q[..., 1]


# ---------------------------------------------------------------- world

def make_world(gen, sim, device):
    """Circular obstacles in a square arena from `gen`: centres (M, 2)
    uniform in +-0.9 extent, pushed out of the 8 m spawn disk, then radii
    (M,) uniform in [r_min, r_max]. Returns (centres, radii, extent)."""
    M = sim["num_obstacles"]
    e = sim["world_extent"] * 0.9
    pos = torch.rand(M, 2, generator=gen, device=device) * (2 * e) - e
    r = pos.norm(dim=-1, keepdim=True)
    pos = torch.where(r < 8.0, pos * (8.0 / (r + 1e-6)), pos)
    radii = sim["obstacle_radius_min"] + torch.rand(
        M, generator=gen, device=device) * (
        sim["obstacle_radius_max"] - sim["obstacle_radius_min"])
    return pos, radii, torch.tensor(float(sim["world_extent"]),
                                    device=device)


def drive_cmd(step, dt):
    t = step.to(torch.float32) * dt
    vx = 1.2 + 0.3 * torch.sin(0.23 * t)
    om = 0.25 * torch.sin(0.11 * t) + 0.08
    return torch.stack([vx, torch.zeros_like(vx), om], -1)


def unicycle(pose, cmd, dt):
    yaw = pose[:, 2] + cmd[:, 2] * dt
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([pose[:, 0] + (cmd[:, 0] * c - cmd[:, 1] * s) * dt,
                        pose[:, 1] + (cmd[:, 0] * s + cmd[:, 1] * c) * dt,
                        wrap(yaw)], -1)


def beam_angles(n, device):
    return torch.arange(n, dtype=torch.float32, device=device) * \
        (2 * math.pi / n)


def raycast(world, pose, sim, noise=None):
    """Ranges and hits (B, N) of the beams from poses (B, 3): the nearest
    positive circle or wall crossing, beam_max_range where none is nearer;
    `noise` (B, N) standard normals times range_noise is added."""
    centers, radii, e = world
    ang = pose[:, 2:3] + beam_angles(sim["num_beams"], pose.device)
    d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)        # (B, N, 2)
    o = pose[:, :2]
    oc = o[:, None, :] - centers[None]                           # (B, M, 2)
    b = mm(d, oc.mT)                                             # (B, N, M)
    c = (oc * oc).sum(-1)[:, None, :] - (radii ** 2)[None, None]
    disc = b * b - c
    tc = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    tc = torch.where((disc > 0) & (tc > 1e-3), tc, float("inf")).amin(-1)
    walls = []
    for axis in (0, 1):
        den = d[..., axis]
        den = torch.where(den.abs() < 1e-9, 1e-9, den)
        for sign in (1.0, -1.0):
            t = (sign * e - o[:, axis:axis + 1]) / den
            other = o[:, 1 - axis:2 - axis] + t * d[..., 1 - axis]
            walls.append(torch.where((t > 1e-3) & (other.abs() <= e + 1e-6),
                                     t, float("inf")))
    t = torch.minimum(tc, torch.stack(walls).amin(0))
    hit = t < sim["beam_max_range"]
    t = torch.where(hit, t, float(sim["beam_max_range"]))
    if noise is not None:
        t = t + sim["range_noise"] * noise
    return t, hit


def scan_planes(ranges):
    rel = beam_angles(ranges.shape[-1], ranges.device)
    return ranges * torch.cos(rel), ranges * torch.sin(rel)


# ------------------------------------------------------------------ EKF

def init_state(gen, cfg, batch, device):
    """The state before the first tick: mu 0, sigma init_sigma I, the gyro
    bias the mean of num_init_imu_samples stationary readings drawn from
    `gen` (zero without one), every map empty."""
    e, sim, mls, cl = cfg["ekf"], cfg["sim"], cfg["mls"], cfg["cloud"]
    bias = torch.zeros(batch, device=device)
    if gen is not None:
        noise = torch.randn(batch, e["num_init_imu_samples"], generator=gen,
                            device=device)
        bias = (sim["gyro_bias"] + sim["gyro_noise"] * noise).mean(-1)
    z4 = torch.zeros(batch, 4, device=device)
    G = mls["size_x"]
    zg = torch.zeros(batch, G, G, device=device)
    zc = torch.zeros(batch, cl["map_capacity"], device=device)
    zs = torch.zeros(batch, cl["scene_capacity"], device=device)
    return dict(
        mu=torch.zeros(batch, 8, device=device),
        sigma=torch.eye(8, device=device).expand(batch, 8, 8).clone()
        * e["init_sigma"],
        gyro_bias=bias, pose=z4, true_pose=z4.clone(), reg_pose=z4.clone(),
        reg_ok=torch.zeros(batch, dtype=torch.bool, device=device),
        step=torch.zeros(batch, dtype=torch.int64, device=device),
        occ_counts=zg.clone(),
        occ_drivable=torch.full((batch, G, mls["size_y"]), -1,
                                dtype=torch.int8, device=device),
        occ_center=torch.zeros(batch, 2, device=device),
        pm_count=zg.clone(), pm_sx=zg.clone(), pm_sy=zg.clone(),
        pm_sz=zg.clone(), pm_center=torch.zeros(batch, 2, device=device),
        scene_x=zs, scene_y=zs.clone(), scene_valid=zs > 0,
        scene_ga=zs > 0, tgt_x=zc, tgt_y=zc.clone(), tgt_z=zc.clone(),
        tgt_ga=zc > 0, tgt_valid=zc > 0)


def clamp_cmd(cmd, e):
    cmd = torch.where(torch.isnan(cmd).any(-1, keepdim=True), 0.0, cmd)
    return torch.cat([cmd[:, :2].clamp(-e["cmd_vel_max"], e["cmd_vel_max"]),
                      cmd[:, 2:].clamp(-e["cmd_omega_max"],
                                       e["cmd_omega_max"])], -1)


def ekf_predict(mu, sigma, cmd, dt, e):
    cmd = clamp_cmd(cmd, e)
    vx, vy = cmd[:, 0], cmd[:, 1]
    yaw = wrap(mu[:, 6] + mu[:, 7] * dt)
    c, s = torch.cos(yaw), torch.sin(yaw)
    vX, vY = vx * c - vy * s, vx * s + vy * c
    mub = torch.stack([mu[:, 0] + vX * dt, mu[:, 1] + vY * dt, vX, vY, vx,
                       vy, yaw, mu[:, 7]], -1)
    G = torch.eye(8, device=mu.device).repeat(mu.shape[0], 1, 1)
    for k in (2, 3, 4, 5, 7):
        G[:, k, k] = 0.0
    G[:, 0, 2] = dt
    G[:, 1, 3] = dt
    G[:, 2, 4], G[:, 2, 5], G[:, 2, 6] = c, -s, -vx * s - vy * c
    G[:, 3, 4], G[:, 3, 5], G[:, 3, 6] = s, c, vx * c - vy * s
    G[:, 6, 7] = dt
    R = torch.eye(8, device=mu.device) * e["motion_noise"]
    return mub, mm(mm(G, sigma), G.mT) + R


def ekf_gyro(mu, sigma, gyro, bias, e):
    meas = gyro - bias
    C = torch.zeros(8, 1, device=mu.device)
    C[7, 0] = 1.0
    sC = mm(sigma, C)                                         # (B, 8, 1)
    K = sC / (mm(C.mT, sC) + e["meas_noise_yaw"])
    mu2 = mu + (K * (meas - mu[:, 7])[:, None, None])[..., 0]
    mu2 = torch.cat([mu2[:, :6], wrap(mu2[:, 6:7]), mu2[:, 7:]], -1)
    sigma2 = mm(torch.eye(8, device=mu.device) - mm(K, C.mT), sigma)
    has = torch.isfinite(meas)
    return (torch.where(has[:, None], mu2, mu),
            torch.where(has[:, None, None], sigma2, sigma))


def ekf_slam(mu, sigma, meas, has, e):
    C = torch.zeros(3, 8, device=mu.device)
    C[0, 0] = C[1, 1] = C[2, 6] = 1.0
    pred = mm(C, mu[:, :, None])[..., 0]
    innov = torch.stack([meas[:, 0] - pred[:, 0], meas[:, 1] - pred[:, 1],
                         wrap(wrap(meas[:, 2]) - pred[:, 2])], -1)
    S = mm(mm(C, sigma), C.T) + torch.eye(3, device=mu.device) * \
        e["meas_noise_slam"]
    K = mm(mm(sigma, C.T), torch.linalg.inv(S))
    mu2 = mu + mm(K, innov[:, :, None])[..., 0]
    sigma2 = mm(torch.eye(8, device=mu.device) - mm(K, C), sigma)
    has = has & torch.isfinite(meas).all(-1)
    return (torch.where(has[:, None], mu2, mu),
            torch.where(has[:, None, None], sigma2, sigma))


def xyyaw(mu):
    return torch.stack([mu[:, 0], mu[:, 1], mu[:, 6]], -1)


# ---------------------------------------------------------------- grids

def cell_sum(ci, cj, values, keep, H, W):
    """Per-robot sums of (B, N) values (None: ones) at cells (ci, cj) of
    (B, H, W) grids; points off the grid or not kept add nothing."""
    B = ci.shape[0]
    inb = keep & (ci >= 0) & (cj >= 0) & (ci < H) & (cj < W)
    flat = (torch.arange(B, device=ci.device)[:, None] * (H * W) +
            torch.where(inb, ci * W + cj, 0)).reshape(-1)
    v = inb.float() if values is None else torch.where(inb, values, 0.0)
    out = torch.zeros(B * H * W, device=ci.device)
    out.index_add_(0, flat, v.reshape(-1).float())
    return out.view(B, H, W)


def cell_read(grid, ci, cj):
    B, H, W = grid.shape
    flat = (ci.clamp(0, H - 1) * W + cj.clamp(0, W - 1)).long()
    return torch.gather(grid.reshape(B, -1), 1, flat)


def empty_neighbours(occ):
    """Empty 8-neighbours of every cell; off-grid neighbours count as not
    empty."""
    e = torch.nn.functional.pad((~occ).float(), (1, 1, 1, 1))
    H, W = occ.shape[-2:]
    return sum(e[..., a:a + H, b:b + W] for a in range(3)
               for b in range(3)) - (~occ).float()


def interior(H, W, device):
    i = torch.arange(H, device=device)
    j = torch.arange(W, device=device)
    return ((i > 0) & (i < H - 1))[:, None] & ((j > 0) & (j < W - 1))


def roll(a, d):
    """out[b, i, j] = a[b, (i + d0) % H, (j + d1) % W]."""
    B, H, W = a.shape[:3]
    i = (torch.arange(H, device=a.device)[None] + d[:, :1]) % H
    j = (torch.arange(W, device=a.device)[None] + d[:, 1:]) % W
    return a[torch.arange(B, device=a.device)[:, None, None],
             i[:, :, None], j[:, None, :]]


def shift(center, target_xy, res, chans, fills):
    """Re-centre grids on target_xy by whole cells (half to even), rolling
    each channel and filling the cells that wrap in."""
    d = torch.round(div(target_xy - center, res)).long()
    H, W = chans[0].shape[1:3]
    i = torch.arange(H, device=d.device)[None, :, None] + d[:, 0, None, None]
    j = torch.arange(W, device=d.device)[None, None, :] + d[:, 1, None, None]
    fresh = (i < 0) | (i >= H) | (j < 0) | (j >= W)
    out = [torch.where(fresh, torch.tensor(f, dtype=c.dtype,
                                           device=c.device), roll(c, d))
           for c, f in zip(chans, fills)]
    return center + d.float() * res, out


# ---------------------------------------------------------------- scene

def build_scene(px, py, hit, icp, cap):
    """Voxel scene of (B, N) scan planes at the GA grid's resolution: the
    first point of each cell keeps a slot and holds the cell's centroid
    (the cell centre plus the mean offset of its points); a cell is GA
    when interior with >= ga_threshold empty neighbours. Returns (x, y,
    valid, ga) of `cap` slots."""
    B, N = px.shape
    res, G = icp["ga_resolution"], icp["ga_num_bins"]
    ci = torch.floor(div(px, res)).long() + G // 2
    cj = torch.floor(div(py, res)).long() + G // 2
    inb = hit & (ci >= 0) & (cj >= 0) & (ci < G) & (cj < G)
    ccx = (ci.float() - G // 2 + 0.5) * res
    ccy = (cj.float() - G // 2 + 0.5) * res
    n = cell_sum(ci, cj, None, inb, G, G)
    ox = cell_sum(ci, cj, px - ccx, inb, G, G)
    oy = cell_sum(ci, cj, py - ccy, inb, G, G)
    cell = ci.clamp(0, G - 1) * G + cj.clamp(0, G - 1)
    first = torch.full((B, G * G), N, dtype=torch.long, device=px.device)
    pos = torch.arange(N, device=px.device).expand(B, N)
    first.scatter_reduce_(1, torch.where(inb, cell, 0),
                          torch.where(inb, pos, N), reduce="amin")
    keep = inb & (torch.gather(first, 1, cell) == pos)
    occ = n > 0
    ga_cell = occ & interior(G, G, px.device) & \
        (empty_neighbours(occ) >= icp["ga_threshold"])
    cnt = torch.clamp(cell_read(n, ci, cj), min=1.0)
    sx = ccx + cell_read(ox, ci, cj) / cnt
    sy = ccy + cell_read(oy, ci, cj) / cnt
    ga = keep & (cell_read(ga_cell.float(), ci, cj) > 0.5)
    # pack the kept points to the front, in scan order
    slot = torch.cumsum(keep.long(), -1) - 1
    slot = torch.where(keep & (slot < cap), slot, cap)

    def pack(v):
        out = torch.zeros(B, cap + 1, device=px.device)
        return out.scatter_(1, slot, v.float())[:, :cap]
    if N <= cap:                    # no compaction: slots stay in scan order
        padn = cap - N
        z = torch.nn.functional.pad
        return (z(torch.where(keep, sx, 0.0), (0, padn)),
                z(torch.where(keep, sy, 0.0), (0, padn)),
                z(keep, (0, padn)), z(ga, (0, padn)))
    valid = pack(keep) > 0.5
    return (torch.where(valid, pack(sx), 0.0),
            torch.where(valid, pack(sy), 0.0), valid, pack(ga) > 0.5)


# ------------------------------------------------------------------ ICP

# a squared distance this close to the inlier gate or to the next
# candidate's is a near-tie: the program, whose sums round in another
# order, may decide it the other way, and the robot's pose may then part
# from the reference's by a few mm (see the drivers' checks)
NEAR = 1e-5


def near_ties(d2, rmin, part, inlier):
    """(B,) robots with a participating scene point whose nearest squared
    distance lies within NEAR of the inlier gate, or whose next candidate
    lies within NEAR of its nearest (below the gate)."""
    above = torch.where(d2 > rmin, d2, float("inf")).amin(-1, keepdim=True)
    gate = (rmin - inlier).abs() < NEAR
    tie = (above - rmin < NEAR) & (rmin < inlier + NEAR)
    return ((gate | tie)[..., 0] & part).any(-1)


def icp_points(sx, sy, s_valid, s_ga, mx, my, m_valid, m_ga, init, icp_cfg,
        ties):
    """Class-constrained point-to-point ICP of scenes (B, S) onto models
    (B, C) from poses init (B, 3): each scene point's nearest valid model
    point of its own class (squared distance against inlier_dist, which
    the configurations state as a squared distance), a scene class taking
    part only where the model holds more than 3 points of it; the weighted
    Kabsch step; up to max_iterations steps, a robot stopping once its
    step moves less than min_delta or finds no pair. ties "mean": the
    nearest points tied at the minimum are averaged; "first": the first
    one is taken. A robot needs min_scene_points scene and 5 model points.
    The pose is carried as x, y and yaw; the scene is placed, and the
    cross-covariance taken, as matrix products (the "points" matcher's
    arithmetic). Returns (pose (B, 3), ok (B,), num_corr (B,),
    iterations (B,)); icp_fused is the same fit in the fused kernels'
    arithmetic."""
    B = sx.shape[0]
    ok = (s_valid.sum(-1) >= icp_cfg["min_scene_points"]) & \
        (m_valid.sum(-1) >= 5)
    ga_on = (m_valid & m_ga).sum(-1) > 3
    nga_on = (m_valid & ~m_ga).sum(-1) > 3
    part = s_valid & torch.where(s_ga, ga_on[:, None], nga_on[:, None])
    other = (s_ga[:, :, None] != m_ga[:, None, :]) | ~m_valid[:, None, :]
    pose = init.clone()
    done = ~ok
    ncorr = torch.zeros(B, dtype=torch.long, device=sx.device)
    near = torch.zeros(B, dtype=torch.bool, device=sx.device)
    iters = torch.zeros(B, dtype=torch.long, device=sx.device)
    m = torch.stack([mx, my], -1)
    for _ in range(icp_cfg["max_iterations"]):
        qx, qy = place_mm(pose, sx, sy)
        dx = qx[:, :, None] - mx[:, None, :]
        dy = qy[:, :, None] - my[:, None, :]
        d2 = torch.where(other, BIG, dx * dx + dy * dy)
        rmin, first = d2.min(-1)
        near = near | (~done & near_ties(d2, rmin[..., None], part,
                                         icp_cfg["inlier_dist"]))
        w = (part & (rmin < icp_cfg["inlier_dist"])).float()
        if ties == "mean":
            sel = (d2 <= rmin[..., None]).float()
            corr = mm(sel, m) / sel.sum(-1, keepdim=True).clamp(min=1.0)
        else:
            corr = torch.gather(m, 1, first[..., None].expand(-1, -1, 2))
        q = torch.stack([qx, qy], -1)
        ws = w.sum(-1).clamp(min=1e-12)
        mq = (w[..., None] * q).sum(1) / ws[:, None]
        mm_ = (w[..., None] * corr).sum(1) / ws[:, None]
        H = mm(((q - mq[:, None]) * w[..., None]).mT, corr - mm_[:, None])
        dyaw = torch.atan2(H[:, 0, 1] - H[:, 1, 0], H[:, 0, 0] + H[:, 1, 1])
        R = rot(dyaw)
        dt = mm_ - mm(R, mq[..., None])[..., 0]
        new = torch.cat([mm(R, pose[:, :2, None])[..., 0] + dt,
                         wrap(pose[:, 2:] + dyaw[:, None])], -1)
        # |R - I|_F = sqrt(4 - 4 cos(dyaw)), against the step's translation
        delta = torch.maximum(torch.sqrt(torch.clamp(
            4.0 - 4.0 * torch.cos(dyaw), min=0.0)), dt.norm(dim=-1))
        n = w.sum(-1).long()
        has = n > 0
        live = ~done
        iters = iters + live.long()
        pose = torch.where((live & has)[:, None], new, pose)
        ncorr = torch.where(live, n, ncorr)
        done = done | ~has | (delta < icp_cfg["min_delta"])
        if bool(done.all()):
            break
    pose = torch.where(ok[:, None], pose, init)
    return pose, ok & (ncorr > 0), ncorr, iters, near


def tf(x):
    """x, rounded to TF32 under the control (an operand of a product)."""
    return _tf32(x) if TF32[0] else x


def icp_fused(sx, sy, s_valid, s_ga, mx, my, m_valid, m_ga, init, icp_cfg):
    """icp_points with the tied nearest points averaged, in the fused
    kernels' arithmetic: the pose carried as x, y, cos and sin (the step's
    rotation composed onto them, then renormalised), each point placed by
    its own products and sums, the fit from the ten moment sums (inliers,
    their sums of q and of the matched points, and the four products of
    q with the matched points). Returns what icp_points does."""
    B = sx.shape[0]
    ok = (s_valid.sum(-1) >= icp_cfg["min_scene_points"]) & \
        (m_valid.sum(-1) >= 5)
    ga_on = (m_valid & m_ga).sum(-1) > 3
    nga_on = (m_valid & ~m_ga).sum(-1) > 3
    part = s_valid & torch.where(s_ga, ga_on[:, None], nga_on[:, None])
    other = (s_ga[:, :, None] != m_ga[:, None, :]) | ~m_valid[:, None, :]
    tx, ty = init[:, 0].clone(), init[:, 1].clone()
    c, s = torch.cos(init[:, 2]), torch.sin(init[:, 2])
    done = ~ok
    ncorr = torch.zeros(B, device=sx.device)
    near = torch.zeros(B, dtype=torch.bool, device=sx.device)
    iters = torch.zeros(B, dtype=torch.long, device=sx.device)
    mx3, my3 = mx[:, None, :], my[:, None, :]
    for _ in range(icp_cfg["max_iterations"]):
        if bool(done.all()):
            break
        qx = tf(c)[:, None] * tf(sx) - tf(s)[:, None] * tf(sy) + tx[:, None]
        qy = tf(s)[:, None] * tf(sx) + tf(c)[:, None] * tf(sy) + ty[:, None]
        dx = qx[:, :, None] - mx3
        dy = qy[:, :, None] - my3
        d2 = torch.where(other, BIG, dx * dx + dy * dy)
        rmin = d2.amin(-1, keepdim=True)
        near = near | (~done & near_ties(d2, rmin, part,
                                         icp_cfg["inlier_dist"]))
        w = (part[..., None] & (rmin < icp_cfg["inlier_dist"])).float()
        sel = (d2 <= rmin).float() * w
        n_t = sel.sum(-1, keepdim=True).clamp(min=1.0)
        ux = ((sel * mx3).sum(-1, keepdim=True) / n_t)[..., 0]
        uy = ((sel * my3).sum(-1, keepdim=True) / n_t)[..., 0]
        w = w[..., 0]
        W = w.sum(-1)
        Ws = W.clamp(min=1e-12)
        mqx, mqy = (w * qx).sum(-1) / Ws, (w * qy).sum(-1) / Ws
        mmx, mmy = ux.sum(-1) / Ws, uy.sum(-1) / Ws
        H00 = (tf(qx) * tf(ux)).sum(-1) - W * mqx * mmx
        H01 = (tf(qx) * tf(uy)).sum(-1) - W * mqx * mmy
        H10 = (tf(qy) * tf(ux)).sum(-1) - W * mqy * mmx
        H11 = (tf(qy) * tf(uy)).sum(-1) - W * mqy * mmy
        a, b = H00 + H11, H01 - H10
        rn = torch.rsqrt(torch.clamp(a * a + b * b, min=1e-24))
        cd, sd = a * rn, b * rn
        t_x = mmx - (cd * mqx - sd * mqy)
        t_y = mmy - (sd * mqx + cd * mqy)
        ntx, nty = cd * tx - sd * ty + t_x, sd * tx + cd * ty + t_y
        nc, ns = cd * c - sd * s, sd * c + cd * s
        rnorm = torch.rsqrt(torch.clamp(nc * nc + ns * ns, min=1e-24))
        nc, ns = nc * rnorm, ns * rnorm
        # |R - I|_F = sqrt(4 - 4 cos), against the step's translation
        delta = torch.maximum(torch.sqrt(torch.clamp(4.0 - 4.0 * cd, min=0.0)),
                              torch.sqrt(t_x * t_x + t_y * t_y))
        has = W > 0.0
        delta = torch.where(has, delta, -1.0)
        live = ~done
        iters = iters + live.long()
        go = live & has
        tx, ty = torch.where(go, ntx, tx), torch.where(go, nty, ty)
        c, s = torch.where(go, nc, c), torch.where(go, ns, s)
        ncorr = torch.where(live, W, ncorr)
        done = done | (delta < icp_cfg["min_delta"])
    pose = torch.stack([tx, ty, torch.atan2(s, c)], -1)
    pose = torch.where(ok[:, None], pose, init)
    return pose, ok & (ncorr > 0), ncorr.long(), iters, near


# ----------------------------------------------------------------- maps

def point_map_add(st, qx, qy, valid, res):
    G = st["pm_count"].shape[-1]
    rx = qx - st["pm_center"][:, :1]
    ry = qy - st["pm_center"][:, 1:]
    cx = torch.floor(div(rx, res)).long() + G // 2
    cy = torch.floor(div(ry, res)).long() + G // 2
    ox = rx - (cx.float() - G // 2 + 0.5) * res
    oy = ry - (cy.float() - G // 2 + 0.5) * res
    st["pm_count"] = st["pm_count"] + cell_sum(cx, cy, None, valid, G, G)
    st["pm_sx"] = st["pm_sx"] + cell_sum(cx, cy, ox, valid, G, G)
    st["pm_sy"] = st["pm_sy"] + cell_sum(cx, cy, oy, valid, G, G)


def point_map_export(st, capacity, res, ga_threshold):
    """The `capacity` most observed occupied cells (equal counts in flat
    cell order) as centroid planes with their GA flags."""
    cnt = st["pm_count"]
    B, G, _ = cnt.shape
    occ = cnt >= 1.0
    ga = occ & interior(G, G, cnt.device) & \
        (empty_neighbours(occ) >= ga_threshold)
    score = torch.where(occ, cnt, 0.0).reshape(B, -1)
    v, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    v, idx = v[:, :capacity], idx[:, :capacity]
    ci, cj = idx // G, idx % G

    def read(g):
        return torch.gather(g.reshape(B, -1), 1, idx)
    n = read(cnt).clamp(min=1.0)
    sel = v >= 1.0
    x = (ci - G // 2 + 0.5) * res + st["pm_center"][:, :1] + read(st["pm_sx"]) / n
    y = (cj - G // 2 + 0.5) * res + st["pm_center"][:, 1:] + read(st["pm_sy"]) / n
    z = read(st["pm_sz"]) / n
    st["tgt_x"] = torch.where(sel, x, 0.0)
    st["tgt_y"] = torch.where(sel, y, 0.0)
    st["tgt_z"] = torch.where(sel, z, 0.0)
    st["tgt_ga"] = sel & (read(ga.float()) > 0.5)
    st["tgt_valid"] = sel


def shift_point_map(st, xy, res):
    st["pm_center"], (st["pm_count"], st["pm_sx"], st["pm_sy"],
                      st["pm_sz"]) = shift(
        st["pm_center"], xy, res,
        (st["pm_count"], st["pm_sx"], st["pm_sy"], st["pm_sz"]),
        (0.0, 0.0, 0.0, 0.0))


def shift_occupancy(st, xy, mls):
    st["occ_center"], (st["occ_counts"], st["occ_drivable"]) = shift(
        st["occ_center"], xy, mls["resolution"],
        (st["occ_counts"], st["occ_drivable"]), (0.0, -1))


def occupancy_add(st, lx, ly, valid, mls):
    H, W = st["occ_counts"].shape[1:]
    cx = torch.floor(div(lx, mls["resolution"])).long() + mls["size_x"] // 2
    cy = torch.floor(div(ly, mls["resolution"])).long() + mls["size_y"] // 2
    keep = valid & (lx * lx + ly * ly <= mls["max_range"] ** 2)
    touch = cell_sum(cx, cy, None, keep, H, W)
    counts = st["occ_counts"] + touch * mls["occupancy_increment"]
    touched = touch > 0
    st["occ_drivable"] = torch.where(
        touched & (counts > mls["min_cluster_points"]), 0,
        torch.where(touched & (counts < mls["min_cluster_points"]), 1,
                    st["occ_drivable"])).to(torch.int8)
    st["occ_counts"] = counts


# ----------------------------------------------------------- tick, macro

def tick(st, world, cfg, gen):
    """One simulated tick of the fleet against the exported target: drive,
    sense (range noise (B, N) and then gyro noise (B,) from `gen`), EKF
    predict and gyro update, scene, registration (ties averaged), EKF SLAM
    update, the scene folded into the point map at the registered pose
    (the prediction where registration failed) and into the occupancy
    grid at the fused pose."""
    sim, e, icp_cfg, mls = cfg["sim"], cfg["ekf"], cfg["icp"], cfg["mls"]
    dt = sim["dt"]
    st = dict(st)
    cmd = clamp_cmd(drive_cmd(st["step"], dt), e)
    true = unicycle(st["true_pose"][:, :3], cmd, dt)
    noise = torch.randn((true.shape[0], sim["num_beams"]), generator=gen,
                        device=true.device)
    ranges, hit = raycast(world, true, sim, noise)
    px, py = scan_planes(ranges)
    gyro = cmd[:, 2] + sim["gyro_bias"] + sim["gyro_noise"] * torch.randn(
        cmd.shape[0], generator=gen, device=cmd.device)

    hit = hit & torch.isfinite(px) & torch.isfinite(py)
    px = torch.where(hit, px, 0.0)
    py = torch.where(hit, py, 0.0)
    mu, sigma = ekf_predict(st["mu"], st["sigma"], cmd, dt, e)
    mu, sigma = ekf_gyro(mu, sigma, gyro, st["gyro_bias"], e)
    pred = xyyaw(mu)
    sx, sy, sv, sga = build_scene(px, py, hit, icp_cfg,
                                  cfg["cloud"]["scene_capacity"])
    d = icp_cfg["crop_dist"]
    mv = st["tgt_valid"] & ((st["tgt_x"] - pred[:, :1]).abs() <= d) & \
        ((st["tgt_y"] - pred[:, 1:2]).abs() <= d)
    pose, ok, _, _, near = icp_fused(sx, sy, sv, sga, st["tgt_x"],
                                     st["tgt_y"], mv, st["tgt_ga"], pred,
                                     icp_cfg)
    st["near"] = st.get("near", torch.zeros_like(ok)) | near
    mu, sigma = ekf_slam(mu, sigma, pose, ok, e)
    fused = xyyaw(mu)
    map_pose = torch.where(ok[:, None], pose, pred)
    qx, qy = place(map_pose, sx, sy)
    point_map_add(st, qx, qy, sv, icp_cfg["voxel_leaf_obs"][0])
    yaw_only = torch.stack([fused[:, 0] - st["occ_center"][:, 0],
                            fused[:, 1] - st["occ_center"][:, 1],
                            fused[:, 2]], -1)
    lx, ly = place(yaw_only, sx, sy)
    occupancy_add(st, lx, ly, sv, mls)
    z = torch.zeros_like(fused[:, :1])
    st.update(mu=mu, sigma=sigma, pose=torch.cat([fused, z], -1),
              reg_pose=torch.cat([pose, z], -1), reg_ok=ok,
              scene_x=sx, scene_y=sy, scene_valid=sv, scene_ga=sga,
              step=st["step"] + 1,
              true_pose=torch.cat([true, torch.zeros_like(true[:, :1])], -1))
    return st


def macro(st, world, cfg, gen, ticks):
    """One macro of the fleet: export the registration target from the
    point map, re-centre the point map and the occupancy grid on the
    fused pose, then `ticks` ticks against that target."""
    st = dict(st)
    res = cfg["icp"]["voxel_leaf_obs"][0]
    point_map_export(st, cfg["cloud"]["map_capacity"], res,
                     cfg["icp"]["ga_threshold"])
    shift_point_map(st, st["pose"][:, :2], res)
    shift_occupancy(st, st["pose"][:, :2], cfg["mls"])
    for _ in range(ticks):
        st = tick(st, world, cfg, gen)
    return st


# ----------------------------------------------------------- live frames

def make_frames(gen, world, sim, n, device):
    """(n, num_beams + 4) float32 sensor frames [ranges, gyro, cmd(3)]
    along the drive loop from the origin: the true poses after each of
    steps 0 .. n-1, one raycast of them all, range noise from `gen` on the
    hits (misses at exactly beam_max_range), the gyro reading the
    commanded yaw rate plus the sensor's nominal bias."""
    pose = torch.zeros(1, 3, device=device)
    cmds, poses = [], []
    for step in range(n):
        cmd = drive_cmd(torch.full((1,), step, device=device), sim["dt"])
        pose = unicycle(pose, cmd, sim["dt"])
        cmds.append(cmd[0])
        poses.append(pose[0])
    cmds, poses = torch.stack(cmds), torch.stack(poses)
    ranges, hit = raycast(world, poses, sim)
    noise = torch.randn(ranges.shape, generator=gen, device=device)
    ranges = torch.where(hit, ranges + sim["range_noise"] * noise,
                         float(sim["beam_max_range"]))
    gyro = cmds[:, 2:3] + sim["gyro_bias"]
    return torch.cat([ranges, gyro, cmds], 1).float()


def live_init(cfg, device):
    """One robot's live carry: the EKF (mu 0, sigma init_sigma I, the
    sensor's nominal gyro bias), an empty point map and target."""
    st = init_state(None, cfg, 1, device)
    st["gyro_bias"] = torch.full((1,), float(cfg["sim"]["gyro_bias"]),
                                 device=device)
    return st


def consume(st, frame, cfg):
    """One live frame for one robot: EKF predict with the frame's command
    and gyro update, the scene of the hits (ranges below beam_max_range),
    the target cropped around the prediction, ICP (the first of tied
    nearest points), the EKF SLAM update, the point map re-centred on the
    fused pose, the scene folded in at the registered pose (else the
    prediction) and the target exported anew. Returns (state, fused
    pose (1, 3))."""
    sim, e, icp_cfg = cfg["sim"], cfg["ekf"], cfg["icp"]
    st = dict(st)
    nb = sim["num_beams"]
    ranges = frame[None, :nb]
    gyro = frame[nb:nb + 1]
    cmd = frame[None, nb + 1:nb + 4]
    mu, sigma = ekf_predict(st["mu"], st["sigma"], cmd, sim["dt"], e)
    mu, sigma = ekf_gyro(mu, sigma, gyro, st["gyro_bias"], e)
    pred = xyyaw(mu)
    hit = ranges < sim["beam_max_range"]
    px, py = scan_planes(ranges)
    sx, sy, sv, sga = build_scene(px, py, hit, icp_cfg,
                                  cfg["cloud"]["scene_capacity"])
    d = icp_cfg["crop_dist"]
    mv = st["tgt_valid"] & ((st["tgt_x"] - pred[:, :1]).abs() <= d) & \
        ((st["tgt_y"] - pred[:, 1:2]).abs() <= d)
    pose, ok, _, _, near = icp_points(sx, sy, sv, sga, st["tgt_x"],
                                      st["tgt_y"], mv, st["tgt_ga"], pred,
                                      icp_cfg, "first")
    st["near"] = near
    mu, sigma = ekf_slam(mu, sigma, pose, ok, e)
    fused = xyyaw(mu)
    res = icp_cfg["voxel_leaf_obs"][0]
    shift_point_map(st, fused[:, :2], res)
    qx, qy = place(torch.where(ok[:, None], pose, pred), sx, sy)
    point_map_add(st, qx, qy, sv, res)
    point_map_export(st, cfg["cloud"]["map_capacity"], res,
                     icp_cfg["ga_threshold"])
    st.update(mu=mu, sigma=sigma)
    return st, fused


# --------------------------------------------- the particle fleet, shared map

def pf_scores(count, center, sx, sy, valid, parts, res):
    """(B, P) shares of each robot's valid scan points (B, N) that land in
    occupied cells (count > 0) of the shared grid (1, G, G) at `center`
    under particles (B, P, 3)."""
    G = count.shape[-1]
    c = tf(torch.cos(parts[..., 2]))[..., None]
    s = tf(torch.sin(parts[..., 2]))[..., None]
    x, y = tf(sx)[:, None], tf(sy)[:, None]
    wx = c * x - s * y + parts[..., 0:1]
    wy = s * x + c * y + parts[..., 1:2]
    inv = float(torch.tensor(1.0) / torch.tensor(float(res)))
    cx = torch.floor((wx - center[0, 0]) * inv).long() + G // 2
    cy = torch.floor((wy - center[0, 1]) * inv).long() + G // 2
    inb = valid[:, None] & (cx >= 0) & (cy >= 0) & (cx < G) & (cy < G)
    occ = (count[0] > 0).reshape(-1)
    hit = occ[(cx.clamp(0, G - 1) * G + cy.clamp(0, G - 1))]
    n = valid.sum(-1, keepdim=True).clamp(min=1).float()
    return (inb & hit).sum(-1).float() / n


def pf_match(count, center, sx, sy, valid, pred, res, pf, gen):
    """The particle filter's measurement for the fleet: num_particles
    proposals around the prediction from standard normals (B, P, 3) drawn
    from `gen` (particle 0 on the prediction itself), then a uniform (B,)
    (the systematic resampling's offset, whose particles the tick drops);
    the scan read every score_stride-th point; the pose the softmax
    (temperature) weighted mean of the proposals, accepted where its own
    score reaches min_score. Returns (pose (B, 3), ok (B,))."""
    B = pred.shape[0]
    P = pf["num_particles"]
    noise = torch.randn((B, P, 3), generator=gen, device=pred.device)
    torch.rand((B,), generator=gen, device=pred.device)
    sig = torch.tensor([pf["pos_sigma"], pf["pos_sigma"], pf["yaw_sigma"]],
                       device=pred.device)
    parts = pred[:, None, :] + noise * sig
    parts[:, 0] = pred
    k = max(1, int(pf["score_stride"]))
    sx, sy, valid = sx[:, ::k], sy[:, ::k], valid[:, ::k]
    w = torch.softmax(pf_scores(count, center, sx, sy, valid, parts, res)
                      / pf["temperature"], -1)
    pose = torch.stack([(w * parts[..., 0]).sum(-1),
                        (w * parts[..., 1]).sum(-1),
                        wrap(torch.atan2((w * torch.sin(parts[..., 2])).sum(-1),
                                         (w * torch.cos(parts[..., 2])).sum(-1)))],
                       -1)
    score = pf_scores(count, center, sx, sy, valid, pose[:, None], res)[:, 0]
    return pose, score >= pf["min_score"]


def tick_shared(st, world, cfg, gen, shared):
    """One tick of the particle fleet against the shared grid (`shared`:
    count (1, G, G) and center (1, 2)): tick()'s drive, sensing, EKF and
    scene, the particle matcher in place of ICP, no map of the robot's
    own, the occupancy as tick() updates it. Returns (state, the scene's
    world planes at the registered pose (the EKF's where rejected), and
    its valid mask)."""
    sim, e, icp_cfg, mls = cfg["sim"], cfg["ekf"], cfg["icp"], cfg["mls"]
    dt = sim["dt"]
    st = dict(st)
    cmd = clamp_cmd(drive_cmd(st["step"], dt), e)
    true = unicycle(st["true_pose"][:, :3], cmd, dt)
    noise = torch.randn((true.shape[0], sim["num_beams"]), generator=gen,
                        device=true.device)
    ranges, hit = raycast(world, true, sim, noise)
    px, py = scan_planes(ranges)
    gyro = cmd[:, 2] + sim["gyro_bias"] + sim["gyro_noise"] * torch.randn(
        cmd.shape[0], generator=gen, device=cmd.device)
    hit = hit & torch.isfinite(px) & torch.isfinite(py)
    px = torch.where(hit, px, 0.0)
    py = torch.where(hit, py, 0.0)
    mu, sigma = ekf_predict(st["mu"], st["sigma"], cmd, dt, e)
    mu, sigma = ekf_gyro(mu, sigma, gyro, st["gyro_bias"], e)
    pred = xyyaw(mu)
    sx, sy, sv, sga = build_scene(px, py, hit, icp_cfg,
                                  cfg["cloud"]["scene_capacity"])
    pose, ok = pf_match(shared["count"], shared["center"], sx, sy, sv, pred,
                        icp_cfg["voxel_leaf_obs"][0], cfg["pf"], gen)
    mu, sigma = ekf_slam(mu, sigma, pose, ok, e)
    fused = xyyaw(mu)
    yaw_only = torch.stack([fused[:, 0] - st["occ_center"][:, 0],
                            fused[:, 1] - st["occ_center"][:, 1],
                            fused[:, 2]], -1)
    lx, ly = place(yaw_only, sx, sy)
    occupancy_add(st, lx, ly, sv, mls)
    z = torch.zeros_like(fused[:, :1])
    st.update(mu=mu, sigma=sigma, pose=torch.cat([fused, z], -1),
              reg_pose=torch.cat([pose, z], -1), reg_ok=ok,
              scene_x=sx, scene_y=sy, scene_valid=sv, scene_ga=sga,
              step=st["step"] + 1,
              true_pose=torch.cat([true, torch.zeros_like(true[:, :1])], -1))
    qx, qy = place(torch.where(ok[:, None], pose, fused), sx, sy)
    return st, qx, qy, sv


def macro_shared(st, world, cfg, gen, ticks, shared):
    """One macro of the particle fleet: `ticks` ticks against the shared
    grid as it stood, then this fleet's registered scans summed into a
    zero grid at the shared grid's centre. Returns (state, delta: count,
    sx, sy, sz (1, G, G))."""
    qs = []
    for _ in range(ticks):
        st, qx, qy, sv = tick_shared(st, world, cfg, gen, shared)
        qs.append((qx, qy, sv))
    G = shared["count"].shape[-1]
    zero = torch.zeros(1, G, G, device=shared["count"].device)
    d = dict(pm_count=zero, pm_sx=zero.clone(), pm_sy=zero.clone(),
             pm_sz=zero.clone(), pm_center=shared["center"])
    point_map_add(d, torch.cat([q[0] for q in qs], 1).reshape(1, -1),
                  torch.cat([q[1] for q in qs], 1).reshape(1, -1),
                  torch.cat([q[2] for q in qs], 1).reshape(1, -1),
                  cfg["icp"]["voxel_leaf_obs"][0])
    return st, {k: d["pm_" + k] for k in ("count", "sx", "sy", "sz")}
