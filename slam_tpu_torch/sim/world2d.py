"""Procedural 2D worlds and a batched 360-beam lidar — counterpart of
slam_tpu/sim/world2d.py.

One world (circular obstacles in a square arena) is shared by the fleet;
poses are (B, 3). Random draws come from an explicit torch.Generator: they
cannot reproduce jax.random's streams, so tests hand both packages the same
world arrays and the same noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch import default_device


@dataclasses.dataclass
class World2D:
    centers: torch.Tensor  # (M, 2)
    radii: torch.Tensor    # (M,)
    extent: torch.Tensor   # () half-extent of the square arena


def make_world(generator: torch.Generator, cfg, device=None) -> World2D:
    """Random circular obstacles, pushed out of an 8 m spawn disk; on the
    card unless `device` says otherwise (`generator` must live there too)."""
    device = default_device(device)
    M = cfg.num_obstacles
    e = cfg.world_extent * 0.9
    pos = torch.rand(M, 2, generator=generator, device=device) * (2 * e) - e
    r = pos.norm(dim=-1, keepdim=True)
    pos = torch.where(r < 8.0, pos * (8.0 / (r + 1e-6)), pos)
    radii = cfg.obstacle_radius_min + torch.rand(
        M, generator=generator, device=device) * (
        cfg.obstacle_radius_max - cfg.obstacle_radius_min)
    return World2D(centers=pos, radii=radii,
                   extent=torch.tensor(cfg.world_extent, device=device))


def _beam_angles(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) * \
        (2 * math.pi / n)


def raycast(world: World2D, pose: torch.Tensor, cfg, noise=None,
            generator: torch.Generator | None = None):
    """Cast cfg.num_beams rays from poses (B, 3); returns (ranges, hit),
    both (B, num_beams). Range noise is `noise` (a (B, num_beams) standard
    normal tensor) or, when only `generator` is given, drawn from it; with
    neither the ranges are exact."""
    ang = pose[:, 2:3] + _beam_angles(cfg.num_beams, pose.device)
    d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)       # (B, N, 2)
    o = pose[:, :2]

    # circles: |o + t d - c|^2 = r^2
    oc = o[:, None, :] - world.centers[None]                    # (B, M, 2)
    b_half = torch.einsum("bni,bmi->bnm", d, oc)                # (B, N, M)
    c_term = (oc * oc).sum(-1)[:, None, :] - (world.radii ** 2)[None, None]
    disc = b_half * b_half - c_term
    t_circle = -b_half - torch.sqrt(torch.clamp(disc, min=0.0))
    t_circle = torch.where((disc > 0) & (t_circle > 1e-3), t_circle,
                           float("inf")).amin(-1)

    e = world.extent

    def wall_t(axis, sign):
        denom = d[..., axis]
        t = (sign * e - o[:, axis:axis + 1]) / torch.where(
            denom.abs() < 1e-9, 1e-9, denom)
        other = o[:, 1 - axis:2 - axis] + t * d[..., 1 - axis]
        okw = (t > 1e-3) & (other.abs() <= e + 1e-6)
        return torch.where(okw, t, float("inf"))

    t_wall = torch.minimum(torch.minimum(wall_t(0, 1.0), wall_t(0, -1.0)),
                           torch.minimum(wall_t(1, 1.0), wall_t(1, -1.0)))
    t = torch.minimum(t_circle, t_wall)
    hit = t < cfg.beam_max_range
    t = torch.where(hit, t, cfg.beam_max_range)
    if noise is None and generator is not None:
        noise = torch.randn(t.shape, generator=generator, device=t.device)
    if noise is not None:
        t = t + cfg.range_noise * noise
    return t, hit


def scan_to_points(ranges: torch.Tensor, hit: torch.Tensor, yaw=None):
    """Scans (B, N) -> points (B, N, 3) with z = 0, and the hit mask. In
    the sensor frame when yaw is None, else rotated by each robot's yaw
    (B,) to world orientation."""
    rel = _beam_angles(ranges.shape[-1], ranges.device)
    ang = rel if yaw is None else yaw[..., None] + rel
    x = ranges * torch.cos(ang)
    y = ranges * torch.sin(ang)
    return torch.stack([x, y, torch.zeros_like(x)], -1), hit


def scan_to_planes(ranges: torch.Tensor, hit: torch.Tensor):
    """Sensor-frame (x, y) planes of a scan (B, N)."""
    rel = _beam_angles(ranges.shape[-1], ranges.device)
    return ranges * torch.cos(rel), ranges * torch.sin(rel), hit


def drive_cmd(step: torch.Tensor, dt: float) -> torch.Tensor:
    """Deterministic wavy drive pattern: (B,) steps -> (B, 3) commands."""
    t = step.to(torch.float32) * dt
    vx = 1.2 + 0.3 * torch.sin(0.23 * t)
    om = 0.25 * torch.sin(0.11 * t) + 0.08
    return torch.stack([vx, torch.zeros_like(vx), om], -1)


def unicycle_step(pose: torch.Tensor, cmd: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """True kinematics matching the EKF motion model. (B, 3) -> (B, 3)."""
    yaw = pose[:, 2] + cmd[:, 2] * dt
    c, s = torch.cos(yaw), torch.sin(yaw)
    vX = cmd[:, 0] * c - cmd[:, 1] * s
    vY = cmd[:, 0] * s + cmd[:, 1] * c
    return torch.stack([pose[:, 0] + vX * dt, pose[:, 1] + vY * dt,
                        torch.atan2(torch.sin(yaw), torch.cos(yaw))], -1)
