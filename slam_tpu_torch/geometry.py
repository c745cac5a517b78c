"""SE(2) geometry and the roll/pitch rotations of the 3D path — counterpart
of slam_tpu/geometry.py.

Every function broadcasts over leading batch dims. Yaw follows the
reference's convention, wrapped to [-pi, pi].
"""

from __future__ import annotations

import torch


def angle_wrap(a: torch.Tensor) -> torch.Tensor:
    """Periodic wrap to [-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def subtract_yaw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Acute-angle difference a - b across the +-pi boundary."""
    return angle_wrap(a - b)


def rot2(theta: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def se2_apply(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply poses (..., 3) [x, y, yaw] to points (..., N, 2)."""
    qx, qy = se2_apply_xy(pose, pts[..., 0], pts[..., 1])
    return torch.stack([qx, qy], -1)


def se2_apply_xy(pose: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Planar form: x / y planes (..., N) -> (qx, qy) planes."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x = pose[..., 0][..., None]
    y = pose[..., 1][..., None]
    return c * px - s * py + x, s * px + c * py + y


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a o b for poses (..., 3) [x, y, yaw]: first apply b, then a."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, angle_wrap(a[..., 2] + b[..., 2])], -1)


def se2_inverse(p: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return torch.stack([x, y, -p[..., 2]], -1)


def se2_relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose b in a's frame, a^-1 o b: a keyframe edge's initial guess."""
    return se2_compose(se2_inverse(a), b)


def rot3_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """(..., 3, 3) rotations R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def rp_compensate(pts: torch.Tensor, roll, pitch) -> torch.Tensor:
    """Rotate clouds (..., N, 3) upright by R(roll, pitch, yaw = 0); roll
    and pitch are (...)."""
    R = rot3_from_rpy(roll, pitch, torch.zeros_like(roll))
    return torch.einsum("...ij,...nj->...ni", R, pts)


def quat_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """[w, x, y, z] quaternions (..., 4) of roll / pitch / yaw (...), as
    tf's createQuaternionFromRPY makes them."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([cr * cp * cy + sr * sp * sy,
                        sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy], -1)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw of [w, x, y, z] quaternions (..., 4)."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def se3_matrix(xyz: torch.Tensor, rpy: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous transforms of translations (..., 3) and
    roll / pitch / yaw (..., 3)."""
    R = rot3_from_rpy(rpy[..., 0], rpy[..., 1], rpy[..., 2])
    top = torch.cat([R, xyz[..., :, None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)
