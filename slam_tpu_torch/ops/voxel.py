"""Point-cloud masking, packing and voxel downsampling — counterpart of
slam_tpu/ops/voxel.py (`crop_box`, `compact`, `compact_planes`,
`voxel_downsample_pairwise_planes`), batched over robots."""

from __future__ import annotations

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.types import PointCloud


def crop_box(cloud: PointCloud, center_xy: torch.Tensor,
             half_extent: float) -> PointCloud:
    """Mask points outside the +-half_extent box around center_xy (B, 2)."""
    d = (cloud.xyz[..., :2] - center_xy[:, None, :]).abs()
    return cloud.replace(valid=cloud.valid & (d <= half_extent).all(-1))


def compact_planes(planes: tuple, valid: torch.Tensor, out_capacity: int):
    """Pack the valid entries of (B, N) planes to the front of
    (B, out_capacity) planes, in order; overflow drops the tail. Returns
    (packed planes, packed valid). Boolean planes go in as f32 0/1.
    (slam_tpu permutes with a one-hot matmul; here a cumsum gives each
    valid entry its slot and one scatter writes it.)"""
    B, N = valid.shape
    idx = torch.cumsum(valid.to(torch.int64), -1) - 1
    slot = torch.where(valid & (idx < out_capacity), idx, out_capacity)

    def pack(p):
        out = torch.zeros(B, out_capacity + 1, dtype=torch.float32,
                          device=valid.device)
        return out.scatter_(-1, slot, p.to(torch.float32))[:, :out_capacity]

    return tuple(pack(p) for p in planes), pack(valid) > 0.5


def compact(cloud: PointCloud, out_capacity: int) -> PointCloud:
    """Pack each robot's valid points to the front of a cloud of
    out_capacity slots, in order; overflow drops the tail. The rest of the
    slots are zero, invalid and unflagged."""
    B, N = cloud.valid.shape
    idx = torch.cumsum(cloud.valid.to(torch.int64), -1) - 1
    slot = torch.where(cloud.valid & (idx < out_capacity), idx, out_capacity)
    rows = torch.arange(B, device=slot.device)[:, None]

    def pack(a):
        out = a.new_zeros((B, out_capacity + 1) + a.shape[2:])
        out[rows, slot] = a
        return out[:, :out_capacity]

    return PointCloud(xyz=pack(cloud.xyz), valid=pack(cloud.valid),
                      flags=pack(cloud.flags))


def voxel_downsample_pairwise_planes(px, py, pz, valid, bit_planes: tuple,
                                     leaf):
    """Voxel centroids of (B, N) planes through the same-cell incidence:
    the first valid point of each voxel keeps its slot and carries the
    voxel's centroid (`keep`); every slot's bit planes (0/1 f32) are OR-ed
    over its voxel. Returns ((cx, cy, cz), keep, bits as bool)."""
    B, N = px.shape
    lx, ly, lz = (float(v) for v in leaf)
    qx = torch.floor(true_div(px, lx)).to(torch.int32)
    qy = torch.floor(true_div(py, ly)).to(torch.int32)
    qz = torch.floor(true_div(pz, lz)).to(torch.int32)

    def eq(q):
        return q[:, :, None] == q[:, None, :]
    same = eq(qx) & eq(qy) & eq(qz) & valid[:, :, None] & valid[:, None, :]
    Mf = same.to(torch.float32)
    count = torch.clamp(Mf.sum(-1), min=1.0)
    n_idx = torch.arange(N, device=px.device)
    first = torch.where(same, n_idx, N).amin(-1)
    keep = valid & (first == n_idx)

    def centroid(p, q, leaf_a):
        cc = (q.to(p.dtype) + 0.5) * leaf_a
        rel = torch.where(valid, p - cc, 0.0)
        return cc + (Mf @ rel[..., None])[..., 0] / count

    bits = tuple((Mf @ b[..., None])[..., 0] > 0.5 for b in bit_planes)
    return (centroid(px, qx, lx), centroid(py, qy, ly),
            centroid(pz, qz, lz)), keep, bits
