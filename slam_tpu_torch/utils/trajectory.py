"""Trajectory CSV logging — counterpart of slam_tpu/utils/trajectory.py.

The reference's map builder logs every accepted pose as an `x, y, yaw`
CSV row without a header; the same format here makes trajectories
diffable against runs of the C++ stack and of slam_tpu (numpy text I/O,
the same `%.6g` fields).
"""

from __future__ import annotations

import numpy as np
import torch


def save_trajectory_csv(path: str, poses) -> int:
    """Write (T, 3+) pose rows (a tensor or an array) as `x, y, yaw` CSV,
    columns beyond the third (e.g. z) appended after yaw. Returns the row
    count."""
    if isinstance(poses, torch.Tensor):
        poses = poses.detach().cpu().numpy()
    arr = np.asarray(poses, np.float64)
    if arr.ndim != 2 or arr.shape[1] < 3:
        raise ValueError(f"expected (T, >=3) poses, got {arr.shape}")
    np.savetxt(path, arr, fmt="%.6g", delimiter=", ")
    return arr.shape[0]


def load_trajectory_csv(path: str) -> np.ndarray:
    """Read an `x, y, yaw[, ...]` CSV (no header) as a float64 (T, K)
    array."""
    return np.loadtxt(path, delimiter=",", ndmin=2)
