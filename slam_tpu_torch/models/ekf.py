"""8-state EKF — counterpart of slam_tpu/models/ekf.py, batched over robots.

State: [x, y, vX, vY, vx, vy, yaw, omega] (inertial position and velocity,
body velocity, yaw, body yaw rate). mu is (B, 8), sigma (B, 8, 8); `has_meas`
is a (B,) mask that lets one call mix robots with and without a measurement.
Nothing here copies from the host: constants are Python scalars or rows of
a device-made identity, so a tick's EKF never waits for the card.
"""

from __future__ import annotations

import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.geometry import angle_wrap, subtract_yaw
from slam_tpu_torch.ops.linalg import inv3
from slam_tpu_torch.types import EkfState


def init_ekf(cfg, batch: int, gyro_bias=0.0, device=None,
             dtype=torch.float32) -> EkfState:
    """mu = 0, sigma = init_sigma * I; gyro_bias a float or a (B,) tensor.
    On the card unless `device` says otherwise."""
    device = default_device(device)
    bias = torch.as_tensor(gyro_bias, dtype=dtype, device=device)
    return EkfState(
        mu=torch.zeros(batch, 8, dtype=dtype, device=device),
        sigma=torch.eye(8, dtype=dtype, device=device).expand(batch, 8, 8)
        * cfg.init_sigma,
        gyro_bias=bias.expand(batch).clone(),
    )


def estimate_gyro_bias(gyro_samples: torch.Tensor) -> torch.Tensor:
    """Average of stationary gyro samples (..., N) -> (...)."""
    return gyro_samples.mean(-1)


def clamp_cmd(cmd: torch.Tensor, cfg) -> torch.Tensor:
    """Clamp (B, 3) commands; any NaN component zeroes the whole command."""
    cmd = torch.where(torch.isnan(cmd).any(-1, keepdim=True), 0.0, cmd)
    return torch.cat([cmd[:, :2].clamp(-cfg.cmd_vel_max, cfg.cmd_vel_max),
                      cmd[:, 2:].clamp(-cfg.cmd_omega_max,
                                       cfg.cmd_omega_max)], -1)


def motion_update(state: EkfState, cmd: torch.Tensor, dt: float,
                  cfg) -> EkfState:
    """Predict step; yaw advances with the state's yaw rate mu[7]."""
    mu, sigma = state.mu, state.sigma
    cmd = clamp_cmd(cmd, cfg)
    vx, vy = cmd[:, 0], cmd[:, 1]
    yaw = angle_wrap(mu[:, 6] + mu[:, 7] * dt)
    omega = mu[:, 7]
    c, s = torch.cos(yaw), torch.sin(yaw)
    vX = vx * c - vy * s
    vY = vx * s + vy * c
    mubar = torch.stack([mu[:, 0] + vX * dt, mu[:, 1] + vY * dt, vX, vY,
                         vx, vy, yaw, omega], -1)

    G = torch.zeros_like(sigma)
    G[:, 0, 0] = 1.0
    G[:, 0, 2] = dt
    G[:, 1, 1] = 1.0
    G[:, 1, 3] = dt
    G[:, 2, 4] = c
    G[:, 2, 5] = -s
    G[:, 2, 6] = -vx * s - vy * c
    G[:, 3, 4] = s
    G[:, 3, 5] = c
    G[:, 3, 6] = vx * c - vy * s
    G[:, 6, 6] = 1.0
    G[:, 6, 7] = dt
    R = torch.eye(8, dtype=mu.dtype, device=mu.device) * cfg.motion_noise
    sigmabar = G @ sigma @ G.transpose(-1, -2) + R
    return state.replace(mu=mubar, sigma=sigmabar)


def yaw_rate_update(state: EkfState, gyro_z: torch.Tensor, cfg,
                    has_meas=True) -> EkfState:
    """Gyro yaw-rate update; the bias is subtracted here. gyro_z: (B,)."""
    mubar, sigmabar = state.mu, state.sigma
    meas = gyro_z - state.gyro_bias
    C = torch.eye(8, dtype=mubar.dtype, device=mubar.device)[7]
    sC = sigmabar @ C                                       # (B, 8)
    K = sC / (sC @ C + cfg.meas_noise_yaw)[:, None]
    mu = mubar + K * (meas - mubar[:, 7])[:, None]
    mu = torch.cat([mu[:, :6], angle_wrap(mu[:, 6:7]), mu[:, 7:]], -1)
    eye = torch.eye(8, dtype=mubar.dtype, device=mubar.device)
    sigma = (eye - K[:, :, None] * C) @ sigmabar
    has = torch.isfinite(meas) & has_meas
    return state.replace(mu=torch.where(has[:, None], mu, mubar),
                         sigma=torch.where(has[:, None, None], sigma,
                                           sigmabar))


def slam_update(state: EkfState, meas: torch.Tensor, cfg,
                has_meas=True) -> EkfState:
    """x / y / yaw update with a wrapped yaw innovation. meas: (B, 3)."""
    mubar, sigmabar = state.mu, state.sigma
    eye = torch.eye(8, dtype=mubar.dtype, device=mubar.device)
    C = torch.stack([eye[0], eye[1], eye[6]])               # x, y, yaw rows
    pred = mubar @ C.T                                      # (B, 3)
    innov = torch.stack([meas[:, 0] - pred[:, 0], meas[:, 1] - pred[:, 1],
                         subtract_yaw(angle_wrap(meas[:, 2]), pred[:, 2])],
                        -1)
    Q = torch.eye(3, dtype=mubar.dtype, device=mubar.device) * \
        cfg.meas_noise_slam
    S = C @ sigmabar @ C.T + Q
    K = sigmabar @ C.T @ inv3(S)                            # (B, 8, 3)
    mu = mubar + (K @ innov[:, :, None])[:, :, 0]
    sigma = (eye - K @ C) @ sigmabar
    has = torch.isfinite(meas).all(-1) & has_meas
    return state.replace(mu=torch.where(has[:, None], mu, mubar),
                         sigma=torch.where(has[:, None, None], sigma,
                                           sigmabar))


def pose_xyyaw(state: EkfState) -> torch.Tensor:
    """(B, 3) x, y, yaw of the belief."""
    mu = state.mu
    return torch.stack([mu[:, 0], mu[:, 1], mu[:, 6]], -1)


def global_offset(state: EkfState, delta: torch.Tensor) -> EkfState:
    """Shift each robot's pose by a graph-SLAM / relocalization delta
    (B, 3) [dx, dy, dyaw]: x += dx, y += dy, yaw = wrap(yaw + dyaw)."""
    mu = state.mu
    mu = torch.cat([mu[:, :1] + delta[:, :1], mu[:, 1:2] + delta[:, 1:2],
                    mu[:, 2:6], angle_wrap(mu[:, 6:7] + delta[:, 2:3]),
                    mu[:, 7:]], -1)
    return state.replace(mu=mu)
