"""Procedural 3D worlds and a batched Velodyne-style raycaster — counterpart
of slam_tpu/sim/world3d.py, the fixture of BASELINE config 2.

Terrain is a sum of sines, so a ray meets the ground where a smooth margin
crosses zero: a fixed bracketing march, then regula falsi, for every ray of
every robot at once. Obstacles are vertical cylinders with closed-form
intersections. One world is shared by the fleet; poses are (B, 3). Random
draws come from an explicit torch.Generator, so tests hand both packages
the same world arrays and noise-free scans. On the card `raycast` is one
launch of a hand-written kernel (csrc/raycast3d.cu); `raycast_reference`
is its plain version, which CPU tensors run.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch import cuda_build, default_device
from slam_tpu_torch.geometry import rot3_from_rpy
from slam_tpu_torch.sim.world2d import place_obstacles
from slam_tpu_torch.utils import profiling


@dataclasses.dataclass
class World3D:
    centers: torch.Tensor  # (M, 2) cylinder centres
    radii: torch.Tensor    # (M,)
    heights: torch.Tensor  # (M,) cylinder height above the local ground
    terrain: torch.Tensor  # (K, 4) sine parameters: ax, ay, phase, amp
    extent: torch.Tensor   # () half-extent


def terrain_height(world: World3D, xy: torch.Tensor) -> torch.Tensor:
    """Ground elevation g(x, y) at xy (..., 2) -> (...)."""
    t = world.terrain
    arg = xy[..., 0:1] * t[:, 0] + xy[..., 1:2] * t[:, 1] + t[:, 2]
    return (t[:, 3] * torch.sin(arg)).sum(-1)


def make_world(generator: torch.Generator, cfg, terrain_amp: float = 0.6,
               num_waves: int = 4, device=None) -> World3D:
    """Cylinders placed as the 2D world places its obstacles, with random
    heights, on a terrain of `num_waves` random sines; on the card unless
    `device` says otherwise (`generator` must live there too)."""
    device = default_device(device)
    pos, radii = place_obstacles(generator, cfg, device)
    M = cfg.num_obstacles
    heights = 0.5 + 2.5 * torch.rand(M, generator=generator, device=device)
    freq = 0.02 + 0.06 * torch.rand(num_waves, 2, generator=generator,
                                    device=device)
    phase = torch.linspace(0.0, 3.0, num_waves, device=device)[:, None]
    amp = torch.full((num_waves, 1), terrain_amp / num_waves, device=device)
    return World3D(centers=pos, radii=radii, heights=heights,
                   terrain=torch.cat([freq, phase, amp], -1),
                   extent=torch.tensor(cfg.world_extent, device=device))


def ray_directions(cfg, yaw: torch.Tensor) -> torch.Tensor:
    """(..., R*A, 3) unit directions, rings x azimuths, rotated by yaw
    (...)."""
    dev = yaw.device
    elev = torch.linspace(cfg.ring_elevation_min, cfg.ring_elevation_max,
                          cfg.num_rings, device=dev)
    az = yaw[..., None] + torch.arange(cfg.num_azimuth, device=dev) * (
        2 * math.pi / cfg.num_azimuth)
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(az)[..., None, :], torch.sin(az)[..., None, :]
    x = ce * ca
    d = torch.stack([x, ce * sa, torch.broadcast_to(se, x.shape)], -1)
    return d.reshape(*yaw.shape, -1, 3)


def terrain_attitude(world: World3D, xy: torch.Tensor, eps: float = 0.25):
    """(roll, pitch) of robots resting on the terrain at xy (B, 2), from
    the finite-difference surface gradient."""
    # the offsets (eps, 0) and (0, eps) made on the device: a tensor from a
    # host list, or an element set from a Python number, is a copy that
    # waits for the card
    k = torch.arange(2, device=xy.device)
    ex = (k == 0).to(xy.dtype) * eps
    ey = (k == 1).to(xy.dtype) * eps
    gx = (terrain_height(world, xy + ex) - terrain_height(world, xy - ex)) \
        / (2 * eps)
    gy = (terrain_height(world, xy + ey) - terrain_height(world, xy - ey)) \
        / (2 * eps)
    return torch.atan(gy), -torch.atan(gx)


def sensor_rays(world: World3D, pose: torch.Tensor, cfg, roll=None,
                pitch=None):
    """The scan's geometry for sensors cfg.sensor_height above the terrain
    under poses (B, 3), tilted by roll / pitch (B,): origins (B, 3), the
    untilted sensor-frame pattern d_local (N, 3) and the world-frame ray
    directions d (B, N, 3)."""
    x, y, yaw = pose[:, 0], pose[:, 1], pose[:, 2]
    zero = torch.zeros_like(yaw)
    roll = zero if roll is None else roll
    pitch = zero if pitch is None else pitch
    o = torch.stack([x, y, terrain_height(world, pose[:, :2])
                     + cfg.sensor_height], -1)                     # (B, 3)
    d_local = ray_directions(cfg, zero[:1])[0]                     # (N, 3)
    Rt = rot3_from_rpy(roll, pitch, yaw)                           # (B, 3, 3)
    d = torch.einsum("bij,nj->bni", Rt, d_local)                   # (B, N, 3)
    return o, d_local, d


def raycast(world: World3D, pose: torch.Tensor, cfg, noise=None,
            generator: torch.Generator | None = None, march_steps: int = 16,
            refine_steps: int = 5, roll=None, pitch=None):
    """Cast the ring pattern from sensors at height cfg.sensor_height above
    the terrain under poses (B, 3), tilted by roll / pitch (B,).

    Returns (points (B, R*A, 3) in the tilted sensor frame, hit (B, R*A)).
    Range noise is `noise` (standard normal, (B, R*A)) or, when only
    `generator` is given, drawn from it; with neither the ranges are exact.
    On the card one launch of the raycast kernel (counted as
    `raycast3d.launches`); CPU tensors run raycast_reference.
    """
    if pose.device.type == "cpu":
        return raycast_reference(world, pose, cfg, noise, generator,
                                 march_steps, refine_steps, roll, pitch)
    o, d_local, d = sensor_rays(world, pose, cfg, roll, pitch)
    B, N = d.shape[:2]
    ts = torch.linspace(0.0, cfg.beam_max_range, march_steps,
                        device=pose.device)
    if noise is None and generator is not None:
        noise = torch.randn((B, N), generator=generator, device=d.device)
    cyl = (world.centers.contiguous(), world.radii.contiguous(),
           world.heights.contiguous())
    terrain = world.terrain.contiguous()
    M, K = cyl[0].shape[0], terrain.shape[0]
    ops = (d, d_local, o, ts, *cyl, terrain)
    shapes = [(B, N, 3), (N, 3), (B, 3), (march_steps,), (M, 2), (M,), (M,),
              (K, 4)]
    if noise is not None:
        noise = noise.contiguous()
        ops, shapes = ops + (noise,), shapes + [(B, N)]
    cuda_build.check_operands("raycast3d", ops, shapes,
                              contiguous=(False,) + (True,) * (len(ops) - 1))
    smem = 4 * (4 * K + 5 * M + march_steps)
    if not 1 <= K <= 8 or B > 65535 or smem > cuda_build.MAX_SMEM:
        raise ValueError(f"the raycast kernel takes 1 to 8 terrain sines, at "
                         f"most 65,535 robots and {cuda_build.MAX_SMEM} bytes "
                         f"of cylinders and march steps: got {K} sines, {B} "
                         f"robots, {smem} bytes")
    points = torch.empty((B, N, 3), dtype=torch.float32, device=d.device)
    hit = torch.empty((B, N), dtype=torch.bool, device=d.device)
    err = cuda_build.library().slam_raycast3d(
        d.data_ptr(), *d.stride(), d_local.data_ptr(), o.data_ptr(),
        ts.data_ptr(), *(t.data_ptr() for t in cyl), terrain.data_ptr(),
        None if noise is None else noise.data_ptr(), points.data_ptr(),
        hit.data_ptr(), B, N, march_steps, M, K, refine_steps,
        cfg.beam_max_range, cfg.range_noise,
        torch.cuda.current_stream(d.device).cuda_stream)
    cuda_build.check(err, "slam_raycast3d")
    profiling.count("raycast3d.launches")
    return points, hit


def raycast_reference(world: World3D, pose: torch.Tensor, cfg, noise=None,
                      generator: torch.Generator | None = None,
                      march_steps: int = 16, refine_steps: int = 5, roll=None,
                      pitch=None):
    """raycast's plain version: the march and the cylinder tests as
    (B, N, T) and (B, N, M) tensors."""
    o, d_local, d = sensor_rays(world, pose, cfg, roll, pitch)
    tmax = cfg.beam_max_range

    # terrain: a march brackets the first crossing of the height margin,
    # regula falsi refines it (slam_tpu/sim/world3d.py explains why 16
    # steps cannot miss a crossing of these terrains)
    ts = torch.linspace(0.0, tmax, march_steps, device=pose.device)
    pts = o[:, None, None, :] + ts[:, None] * d[:, :, None, :]     # (B,N,T,3)
    marg = pts[..., 2] - terrain_height(world, pts[..., :2])       # (B,N,T)
    above = marg > 0
    crossed = above[..., :-1] & ~above[..., 1:]
    has_cross = crossed.any(-1)
    first = (crossed & (torch.cumsum(crossed.to(torch.int32), -1) == 1)
             ).to(marg.dtype)
    lo = (ts[:-1] * first).sum(-1)
    hi = (ts[1:] * first).sum(-1)
    m_lo = (marg[..., :-1] * first).sum(-1)
    m_hi = (marg[..., 1:] * first).sum(-1)
    for _ in range(refine_steps):
        mid = lo + (hi - lo) * m_lo / torch.clamp(m_lo - m_hi, min=1e-12)
        p = o[:, None, :] + mid[..., None] * d
        m_mid = p[..., 2] - terrain_height(world, p[..., :2])
        up = m_mid > 0
        lo = torch.where(up, mid, lo)
        m_lo = torch.where(up, m_mid, m_lo)
        hi = torch.where(up, hi, mid)
        m_hi = torch.where(up, m_hi, m_mid)
    t_star = lo + (hi - lo) * m_lo / torch.clamp(m_lo - m_hi, min=1e-12)
    t_terr = torch.where(has_cross, t_star, float("inf"))

    # cylinders: circle intersection in xy, then the height range
    oc = o[:, None, :2] - world.centers                            # (B, M, 2)
    dxy = d[..., :2]
    a = (dxy * dxy).sum(-1)[..., None]                             # (B, N, 1)
    b_half = torch.einsum("bni,bmi->bnm", dxy, oc)
    c_term = (oc * oc).sum(-1)[:, None, :] - (world.radii ** 2)
    disc = b_half * b_half - a * c_term
    t_cyl = (-b_half - torch.sqrt(torch.clamp(disc, min=0.0))) / \
        torch.clamp(a, min=1e-9)
    pz = o[:, None, 2:3] + t_cyl * d[..., 2:3]
    ground_at = terrain_height(world, world.centers)               # (M,)
    in_z = (pz > ground_at) & (pz < ground_at + world.heights)
    t_cyl = torch.where((disc > 0) & (t_cyl > 1e-3) & in_z, t_cyl,
                        float("inf")).amin(-1)

    t = torch.minimum(t_terr, t_cyl)
    hit = torch.isfinite(t) & (t < tmax)
    t = torch.where(hit, t, tmax)
    if noise is None and generator is not None:
        noise = torch.randn(t.shape, generator=generator, device=t.device)
    if noise is not None:
        t = t + cfg.range_noise * noise
    # sensor-frame points along the untilted pattern: the robot knows
    # neither its yaw nor its tilt
    return t[..., None] * d_local, hit
