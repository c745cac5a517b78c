"""Sensor-frame synthesis for the replay / live transport — counterpart of
slam_tpu/sim/replay.py (`frame_floats`, `synth_frames`).

Frame layout (little-endian float32): [ranges(num_beams), gyro, cmd(3)].
Missed beams are written at exactly cfg.beam_max_range: range noise goes
to hit beams only, so a consumer recovers the hit mask as
`ranges < beam_max_range`. The native loader (runtime/native.py) reads
files of these frames, and slam_tpu_torch.live consumes them.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.sim import world2d


def frame_floats(cfg) -> int:
    """Floats per frame for the layout above."""
    return cfg.num_beams + 4


def drive_poses(n: int, dt: float, device=None):
    """The standard drive loop's commands and true poses after each of
    steps 0 .. n-1, starting at the origin: (cmds (n, 3), poses (n, 3))."""
    pose = torch.zeros(1, 3, device=device)
    cmds, poses = [], []
    for step in range(n):
        cmd = world2d.drive_cmd(torch.full((1,), step, device=device), dt)
        pose = world2d.unicycle_step(pose, cmd, dt)
        cmds.append(cmd[0])
        poses.append(pose[0])
    return torch.stack(cmds), torch.stack(poses)


def synth_frames(world, cfg, n: int, seed: int = 0) -> np.ndarray:
    """(n, num_beams + 4) float32 frames along the standard drive loop: the
    poses first, then one batched raycast of all n (the step is the robot
    dim), then range noise from numpy.random.default_rng(seed) on the host,
    the same draws as slam_tpu's."""
    cmds, poses = drive_poses(n, cfg.dt, world.centers.device)
    rs, hs = world2d.raycast(world, poses, cfg)
    rs = rs.cpu().numpy()
    hs = hs.cpu().numpy()
    cmds = cmds.cpu().numpy()
    rng = np.random.default_rng(seed)
    noisy = rs + rng.normal(0, cfg.range_noise, rs.shape)
    ranges = np.where(hs, noisy, cfg.beam_max_range)
    gyro = cmds[:, 2:3] + cfg.gyro_bias
    return np.concatenate([ranges, gyro, cmds], axis=1).astype("<f4")
