"""Point-cloud masking, packing and voxel downsampling — counterpart of
slam_tpu/ops/voxel.py (`crop_box`, `compact`, `compact_planes`,
`voxel_downsample`, `voxel_downsample_pairwise`,
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


def voxel_downsample(cloud: PointCloud, leaf, out_capacity: int,
                     grid_cells: int = 1024) -> PointCloud:
    """One centroid per occupied voxel of each robot's cloud (B, N), packed
    in ascending voxel id into out_capacity slots (voxels beyond it are
    dropped). Voxel coordinates are bounded to grid_cells per axis (the
    linear id stays below 2^30, an int32); points beyond clamp into the
    border voxels. A voxel's flags are its points' majority, bit by bit
    (exact half-ties keep the bit).

    A stable sort of the voxel ids (invalid points carry int32's maximum,
    above every id, and sort last), prefix sums of each point's offset from
    its voxel's centre (bounded by the leaf, so a segment's sum, a
    difference of two prefixes, keeps its precision), and torch.searchsorted
    over each robot's row of dense voxel ranks for the segment bounds."""
    xyz = cloud.xyz
    B, N, _ = xyz.shape
    leaf = [float(v) for v in leaf]
    K = grid_cells
    q = torch.clamp(torch.stack([torch.floor(true_div(xyz[..., i], leaf[i]))
                                 for i in range(3)], -1).to(torch.int32) +
                    K // 2, 0, K - 1)
    vid = (q[..., 0] * K + q[..., 1]) * K + q[..., 2]
    vid = torch.where(cloud.valid, vid, torch.iinfo(torch.int32).max)
    vid_s, order = torch.sort(vid, dim=-1, stable=True)

    def take(a):
        return torch.gather(a, 1, order.view(order.shape + (1,) * (
            a.dim() - 2)).expand(a.shape))
    xyz_s, valid_s, flags_s, q_s = (take(a) for a in (xyz, cloud.valid,
                                                       cloud.flags, q))
    first = torch.cat([torch.ones_like(valid_s[:, :1]),
                       vid_s[:, 1:] != vid_s[:, :-1]], -1) & valid_s
    # dense voxel rank; invalid points take N, above any rank or slot
    slot = torch.where(valid_s, torch.cumsum(first, -1) - 1, N)

    vox_center = torch.stack([(q_s[..., i] - K // 2).to(xyz.dtype) * leaf[i]
                              + leaf[i] * 0.5 for i in range(3)], -1)
    w = valid_s.to(xyz.dtype)
    fbits = torch.stack([(flags_s >> b) & 1 for b in range(3)], -1)
    csum_xyz = torch.cumsum((xyz_s - vox_center) * w[..., None], 1)
    csum_cnt = torch.cumsum(w, -1)
    csum_fb = torch.cumsum(fbits * valid_s[..., None].to(torch.int32), 1)

    ks = torch.arange(out_capacity, device=xyz.device).repeat(B, 1)
    lo = torch.searchsorted(slot, ks, side="left")
    hi = torch.searchsorted(slot, ks, side="right")
    present = hi > lo
    hi1 = torch.clamp(hi - 1, 0, N - 1)
    lo1 = torch.clamp(lo - 1, 0, N - 1)

    def seg(csum):
        def at(i):
            return i.view(i.shape + (1,) * (csum.dim() - 2)).expand(
                (B, out_capacity) + csum.shape[2:])
        head = torch.gather(csum, 1, at(lo1))
        return torch.gather(csum, 1, at(hi1)) - torch.where(
            at(lo > 0), head, torch.zeros_like(head))

    sums = seg(csum_xyz)
    cnt = torch.where(present, seg(csum_cnt), 0.0)
    fsums = torch.where(present[..., None], seg(csum_fb), 0)
    out_valid = cnt > 0
    centroid = torch.gather(vox_center, 1, hi1[..., None].expand(
        B, out_capacity, 3)) + sums / torch.clamp(cnt, min=1.0)[..., None]
    maj = (fsums * 2 >= cnt[..., None].to(fsums.dtype)) & \
        (cnt[..., None] > 0)
    out_flags = (maj[..., 0] * 1 + maj[..., 1] * 2 + maj[..., 2] * 4
                 ).to(torch.int32)
    return PointCloud(
        xyz=torch.where(out_valid[..., None], centroid, 0.0),
        valid=out_valid, flags=torch.where(out_valid, out_flags, 0))


def voxel_downsample_pairwise(cloud: PointCloud, leaf) -> PointCloud:
    """voxel_downsample's centroids in the input's own slots: the first
    point of each voxel keeps its slot and carries the voxel's centroid,
    the others are masked; flags are OR-ed over the voxel's points."""
    fbits = tuple(((cloud.flags >> b) & 1).to(cloud.xyz.dtype)
                  for b in range(3))
    (cx, cy, cz), keep, bits = voxel_downsample_pairwise_planes(
        cloud.xyz[..., 0], cloud.xyz[..., 1], cloud.xyz[..., 2], cloud.valid,
        fbits, leaf)
    flags = (bits[0].to(torch.int32) * 1 + bits[1].to(torch.int32) * 2 +
             bits[2].to(torch.int32) * 4)
    xyz = torch.stack([cx, cy, cz], -1)
    return PointCloud(xyz=torch.where(keep[..., None], xyz, 0.0), valid=keep,
                      flags=torch.where(keep, flags, 0))
