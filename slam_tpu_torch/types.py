"""State containers: dataclasses of tensors with a leading robot-batch dim B.

Counterparts of slam_tpu/types.py's flax pytrees. Where the JAX package holds
one robot's state and vmaps, every tensor here carries the batch dim first:
a PointCloud's xyz is (B, N, 3), an EkfState's sigma is (B, 8, 8).
"""

from __future__ import annotations

import dataclasses

import torch

from slam_tpu_torch import default_device


class Replaceable:
    """`.replace(**fields)`, as flax struct dataclasses have."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class PointCloud(Replaceable):
    """Fixed-capacity masked cloud.

    xyz:   (B, N, 3) float — coordinates (z is zero on 2D paths)
    valid: (B, N) bool     — capacity mask
    flags: (B, N) int32    — bit 0 ground, bit 1 ground-adjacent (GA),
                             bit 2 drivable-over
    """

    xyz: torch.Tensor
    valid: torch.Tensor
    flags: torch.Tensor

    FLAG_GROUND = 1
    FLAG_GA = 2
    FLAG_DRIVABLE = 4

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def is_ga(self) -> torch.Tensor:
        return (self.flags & PointCloud.FLAG_GA) != 0

    def is_ground(self) -> torch.Tensor:
        return (self.flags & PointCloud.FLAG_GROUND) != 0


def cloud_from_xyz(xyz: torch.Tensor, valid: torch.Tensor | None = None,
                   flags: torch.Tensor | None = None) -> PointCloud:
    """A cloud of points (B, N, 3), all valid and unflagged unless given."""
    shape = xyz.shape[:-1]
    if valid is None:
        valid = torch.ones(shape, dtype=torch.bool, device=xyz.device)
    if flags is None:
        flags = torch.zeros(shape, dtype=torch.int32, device=xyz.device)
    return PointCloud(xyz=xyz, valid=valid, flags=flags)


def select_cloud(pick: torch.Tensor, a: PointCloud,
                 b: PointCloud) -> PointCloud:
    """Robot by robot, cloud a where pick (B,) is True, else cloud b."""
    m = pick[:, None]
    return PointCloud(xyz=torch.where(m[..., None], a.xyz, b.xyz),
                      valid=torch.where(m, a.valid, b.valid),
                      flags=torch.where(m, a.flags, b.flags))


def make_cloud(batch: int, capacity: int, device=None,
               dtype=torch.float32) -> PointCloud:
    """An empty cloud, on the card unless `device` says otherwise."""
    device = default_device(device)
    return PointCloud(
        xyz=torch.zeros(batch, capacity, 3, dtype=dtype, device=device),
        valid=torch.zeros(batch, capacity, dtype=torch.bool, device=device),
        flags=torch.zeros(batch, capacity, dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class EkfState(Replaceable):
    """8-state EKF: mu = [x, y, vX, vY, vx, vy, yaw, omega]."""

    mu: torch.Tensor         # (B, 8)
    sigma: torch.Tensor      # (B, 8, 8)
    gyro_bias: torch.Tensor  # (B,)


@dataclasses.dataclass
class OccupancyGrid(Replaceable):
    """Rolling occupancy / drivability grid.

    counts:   (B, H, W) float — obstacle point mass
    drivable: (B, H, W) int8  — -1 unknown, 0 occupied, 1 drivable
    origin:   (B, 2) int32    — rolling origin in cells
    center:   (B, 2) float    — world xy of the grid's centre cell
    rows:     static parallel/rows.Rows when the grid's rows are split
              over an sp group (counts and drivable then hold the slab's
              h rows), None when whole
    """

    counts: torch.Tensor
    drivable: torch.Tensor
    origin: torch.Tensor
    center: torch.Tensor
    rows: object = None


@dataclasses.dataclass
class MlsGrid(Replaceable):
    """Multi-level-surface grid: a fixed bank of K Gaussian z-clusters per
    cell, kept sorted by mean z with empty slots last.

    mean:     (B, H, W, K, 3) float — cluster means (x, y in the frame the
                                      clouds were given in)
    var_z:    (B, H, W, K) float
    num_pts:  (B, H, W, K) float    — point counts (capped), 0 = empty slot
    drivable: (B, H, W) int8        — -1 unknown, 0 blocked, 1 drivable
    origin:   (B, 2) int32          — rolling origin in cells
    center:   (B, 2) float          — world xy of the grid's centre cell
    rows:     static parallel/rows.Rows when the rows are split over an
              sp group, None when whole
    """

    mean: torch.Tensor
    var_z: torch.Tensor
    num_pts: torch.Tensor
    drivable: torch.Tensor
    origin: torch.Tensor
    center: torch.Tensor
    rows: object = None


@dataclasses.dataclass
class PoseGraph(Replaceable):
    """Fixed-capacity keyframe pose graph per robot.

    node_pose:  (B, N, 4) f32 x, y, yaw, z
    node_valid: (B, N) bool
    node_stamp: (B, N) int32 insertion order, -1 never used (eviction
                reuses slots, so "newest" is a stamp lookup)
    kf_xyz:     (B, N, P, 3) keyframe clouds in their node's frame
    kf_valid:   (B, N, P) bool
    kf_flags:   (B, N, P) int32
    edge_ij:    (B, E, 2) int32 from, to node
    edge_rel:   (B, E, 4) measured relative pose in the from-frame
    edge_info:  (B, E, 4, 4) information (x, y, yaw, z)
    edge_valid: (B, E) bool
    num_nodes, num_edges: (B,) int32
    edges_dropped: (B,) int32 accepted measurements lost to a full table

    The 6-DoF graph (edge_registration "3d") adds, else they are None:
    node_rp:    (B, N, 2) roll, pitch of each node (its keyframe is stored
                in that capture body frame)
    edge_rel6:  (B, E, 6) measured relative pose [t; rotation vector]
    edge_info6: (B, E, 6, 6) LUM information, tangent order [t; w]
    and edge_rel / edge_info then hold their planar projection."""

    node_pose: torch.Tensor
    node_valid: torch.Tensor
    node_stamp: torch.Tensor
    kf_xyz: torch.Tensor
    kf_valid: torch.Tensor
    kf_flags: torch.Tensor
    edge_ij: torch.Tensor
    edge_rel: torch.Tensor
    edge_info: torch.Tensor
    edge_valid: torch.Tensor
    num_nodes: torch.Tensor
    num_edges: torch.Tensor
    edges_dropped: torch.Tensor
    node_rp: object = None
    edge_rel6: object = None
    edge_info6: object = None


@dataclasses.dataclass
class SlamState(Replaceable):
    """Per-robot SLAM state, batched: the scan-to-map fields, the pose
    graph of graph mode, the IMU attitude and the 6-DoF keyframes' ground
    sample of the 3D path and the device metrics ring. The random stream
    is not state here but an explicit torch.Generator argument."""

    ekf: EkfState
    pose: torch.Tensor           # (B, 4) fused pose x, y, yaw, z
    scan_reg_pose: torch.Tensor  # (B, 4) last registration result
    scan_reg_ok: torch.Tensor    # (B,) bool
    local_map: OccupancyGrid
    prev_scene: PointCloud
    map_cloud: PointCloud        # scan-to-map target
    map_grid: object             # PointMapGrid (mapping/point_map.py), or
                                 # None: robots that carry no grid (config
                                 # 5's fleet scores one shared map)
    step: torch.Tensor           # (B,) int32 tick counter
    true_pose: torch.Tensor      # (B, 4) simulation ground truth
    attitude: object = None      # (B, 2) last measured IMU roll / pitch
                                 # (3D path), or None
    graph: object = None         # PoseGraph (graph mode), or None
    graph_full: object = None    # (B,) bool keyframe capacity reached (new
                                 # keyframes evict), or None without graph
    metrics_ring: object = None  # (buf (B, cap, 9), count (B,)) device
                                 # metrics ring (utils/metrics.py), or None
    prev_ground: object = None   # PointCloud (B, keyframe_points): the last
                                 # tick's strided ground sample (robot
                                 # frame) that 6-DoF keyframes carry, or
                                 # None


@dataclasses.dataclass
class GroundMap(Replaceable):
    """World-frame ground store of the 3D path: a centroid grid
    (mapping/point_map.py's PointMapGrid) and its exported cloud, which
    height interpolation reads when cfg.height.source is "cloud"."""

    grid: object
    cloud: PointCloud
