"""Camera <-> lidar calibration geometry — counterpart of slam_tpu/calib.py
(`CameraParams`, `REFERENCE_CAMERA`, `load_extrinsics_yaml`,
`lidar_to_camera`, `camera_to_pixel`, `camera_center`, `pixel_to_ray`,
`ray_to_flat_ground`, `pixel_to_global`).

Transforms batch over any leading dims of pixels or points and run on
their tensor's device. The camera's own matrices (P, T, their inverses and
the ground plane in the camera frame) are data-independent: they are
computed once per (camera, ground height, device) in f32 on the CPU and
moved to the device, so a transform of device tensors makes no host sync
after its first call (and no inversion on the card, whose info check
would sync).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """One camera's calibration (an extrinsics.yaml entry)."""

    projection: tuple      # 12 floats, row-major 3x4 (P)
    extrinsics: tuple      # 16 floats, row-major 4x4 (T: camera -> lidar)

    def P(self, device=None) -> torch.Tensor:
        return _mats(self, device)["P"]

    def T(self, device=None) -> torch.Tensor:
        return _mats(self, device)["T"]


# the reference rover's single zoom camera (extrinsics.yaml:1-5)
REFERENCE_CAMERA = CameraParams(
    projection=(11162.85801, 0.0, 1938.03850, 0.0,
                0.0, 11109.93803, 1270.60007, 0.0,
                0.0, 0.0, 1.0, 0.0),
    extrinsics=(0.0607901, -0.205867, 0.97669, 0.313862,
                -0.99711, 0.0321484, 0.0688373, -0.302954,
                -0.0455703, -0.978052, -0.203318, -0.291717,
                0.0, 0.0, 0.0, 1.0),
)


def load_extrinsics_yaml(text: str) -> List[CameraParams]:
    """Parse the reference's extrinsics.yaml list format: one `- ` block
    per camera with `projection_matrix: [...]` and `extrinsics: [...]`."""
    cams = []
    for block in re.split(r"^- ", text, flags=re.M)[1:]:
        def grab(key):
            m = re.search(key + r":\s*\[([^\]]*)\]", block)
            if m is None:
                raise ValueError(f"camera block without {key}: {block!r}")
            return tuple(float(v) for v in m.group(1).split(","))
        cams.append(CameraParams(projection=grab("projection_matrix"),
                                 extrinsics=grab("extrinsics")))
    return cams


@functools.lru_cache(maxsize=64)
def _mats(cam: CameraParams, device) -> dict:
    """P, T, T^-1, M^-1 (M = P[:, :3]) and the centre C, in f32, computed
    on the CPU and placed on `device`."""
    P = torch.tensor(cam.projection, dtype=torch.float32).reshape(3, 4)
    T = torch.tensor(cam.extrinsics, dtype=torch.float32).reshape(4, 4)
    M = P[:, :3]
    out = dict(P=P, T=T, Tinv=torch.linalg.inv(T), Minv=torch.linalg.inv(M),
               C=-torch.linalg.solve(M, P[:, 3]))
    return {k: v.to(device) for k, v in out.items()}


def _hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def lidar_to_camera(cam: CameraParams, xyz: torch.Tensor) -> torch.Tensor:
    """Lidar-frame xyz (..., 3) -> camera-frame xyz (applies T^-1)."""
    Tinv = _mats(cam, xyz.device)["Tinv"]
    return torch.einsum("ij,...j->...i", Tinv, _hom(xyz))[..., :3]


def camera_to_pixel(cam: CameraParams, xyz: torch.Tensor) -> torch.Tensor:
    """Camera-frame xyz (..., 3) -> pixel uv (..., 2)."""
    p = torch.einsum("ij,...j->...i", _mats(cam, xyz.device)["P"], _hom(xyz))
    return p[..., :2] / p[..., 2:3]


def camera_center(cam: CameraParams, device=None) -> torch.Tensor:
    """Projection centre in the camera frame, C = -M^-1 P[:, 3]: zero for
    the reference camera."""
    return _mats(cam, device)["C"]


def pixel_to_ray(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixel uv (..., 2) -> unit ray (..., 3) in the camera frame through
    the projection matrix's left inverse M^-1 [u, v, 1] (skew and a fourth
    column honoured)."""
    Minv = _mats(cam, uv.device)["Minv"]
    h = torch.stack([uv[..., 0], uv[..., 1], torch.ones_like(uv[..., 0])],
                    -1)
    ray = torch.einsum("ij,...j->...i", Minv, h)
    return ray / torch.sqrt((ray * ray).sum(-1, keepdim=True))


@functools.lru_cache(maxsize=64)
def _ground_plane(cam: CameraParams, ground_height: float, device):
    """A point c1 on the lidar-frame plane z = ground_height and the
    plane's normal n, both in the camera frame."""
    r = torch.tensor([[0.0, 1.0, ground_height], [0.0, -1.0, ground_height],
                      [-1.0, 0.0, ground_height]], dtype=torch.float32)
    c1, c2, c3 = lidar_to_camera(cam, r).unbind(0)
    n = torch.linalg.cross(c3 - c1, c3 - c2)
    return c1.to(device), n.to(device)


def ray_to_flat_ground(cam: CameraParams, ray: torch.Tensor,
                       ground_height: float) -> torch.Tensor:
    """Intersect camera rays (..., 3) through camera_center with the
    lidar-frame plane z = ground_height; lidar-frame points (..., 3). Rays
    parallel to the plane or meeting it behind the camera give NaN."""
    c1, n = _ground_plane(cam, float(ground_height), ray.device)
    C = camera_center(cam, ray.device)
    denom = torch.einsum("...i,i->...", ray, n)
    small = torch.abs(denom) < 1e-9
    d = torch.dot(c1 - C, n) / torch.where(small, 1.0, denom)
    ok = ~small & (d > 0.0)
    cp = C + d[..., None] * ray
    rp = torch.einsum("ij,...j->...i", _mats(cam, ray.device)["T"], _hom(cp))
    return torch.where(ok[..., None], rp[..., :3], float("nan"))


def pixel_to_global(cam: CameraParams, uv: torch.Tensor, pose4: torch.Tensor,
                    sensor_ground_height: float = -1.3) -> torch.Tensor:
    """Pixel uv (..., 2) -> global-frame ground point (..., 3) for robot
    poses pose4 (..., 4) = (x, y, yaw, z), broadcast against uv's leading
    dims."""
    rp = ray_to_flat_ground(cam, pixel_to_ray(cam, uv), sensor_ground_height)
    c, s = torch.cos(pose4[..., 2]), torch.sin(pose4[..., 2])
    gx = c * rp[..., 0] - s * rp[..., 1] + pose4[..., 0]
    gy = s * rp[..., 0] + c * rp[..., 1] + pose4[..., 1]
    gz = rp[..., 2] + pose4[..., 3]
    return torch.stack([gx, gy, gz], -1)
