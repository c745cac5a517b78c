"""Typed configuration tree: the port's own copy of slam_tpu/config.py.

The same frozen dataclasses, with the same field names, defaults and order,
and the same constructors (`default_config`, `sim2d_config`,
`sim3d_config`, `ref_scale_config`) and `apply_sweep_overrides`, so a config means the same in both
packages (tests/test_torch_config.py holds them equal field for field).
Provenance of each value (file:line of the servos/SLAM reference) is in
slam_tpu/config.py. The port imports nothing of that package, not even this
file.

Fields that select an engine keep the JAX package's names; the port raises
for an engine it has not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _fd(**kw):
    return dataclasses.field(**kw)


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """8-state EKF constants."""

    loop_rate_hz: float = 100.0
    path_publish_iters: int = 100
    motion_noise: float = 0.05           # R = 0.05 * I8
    meas_noise_yaw: float = 0.01         # gyro yaw-rate
    meas_noise_slam: float = 10.0        # Qslam = 10 * I3
    num_init_imu_samples: int = 200      # gyro-bias init window
    init_sigma: float = 0.001            # initial covariance scale
    cmd_vel_max: float = 3.0             # linear command clamp [m/s]
    cmd_omega_max: float = 0.75          # yaw-rate command clamp [rad/s]


@dataclasses.dataclass(frozen=True)
class GroundSegConfig:
    """GP-INSAC ground segmentation."""

    num_sectors: int = 72
    num_range_bins: int = 200
    r_max: float = 100.0
    num_seed_points: int = 10
    gp_length_scale: float = 10.0
    gp_signal_var: float = 1.0
    gp_noise: float = 0.3
    gp_model_confidence: float = 5.0
    gp_data_confidence: float = 5.0
    ground_threshold: float = 0.3
    robot_height: float = 1.2
    seed_max_range: float = 50.0
    seed_max_height: float = 15.0
    min_bin_points: int = 5
    max_insac_sweeps: int = 10
    signal_capacity: int = 64            # per-sector signal set capacity


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Class-constrained 2D ICP and the scan-to-map matcher."""

    max_points: int = 20000              # per class
    max_iterations: int = 20
    # scan-to-map matcher: "fused" (whole fit loop in one kernel, K1),
    # "points" (icp_fit on nearest-neighbour kernel K4), "grid" (the
    # nearest-centroid field of the point-map grid, ops/grid_icp.py),
    # "particle" (particle filter on the point-map grid, kernel K5; cfg.pf)
    matcher: str = "fused"
    loop: str = "while"                  # grid-matcher loop form ("scan"
                                         # or "while": the same result)
    min_delta: float = 1e-6              # convergence gate
    inlier_dist: float = 5.0
    crop_dist: float = 75.0              # target crop half-extent [m]
    min_scene_points: int = 5
    # ground-adjacency (GA) reclassification grid
    ga_num_bins: int = 1200
    ga_resolution: float = 0.5           # [m]
    ga_threshold: int = 2                # >= 2 empty neighbours
    scan_grid_bins: int = 512            # scatter scene builder's grid
    voxel_leaf_obs: Tuple[float, float, float] = (0.5, 0.5, 2.0)
    voxel_leaf_ground: Tuple[float, float, float] = (0.5, 0.5, 5.0)


@dataclasses.dataclass(frozen=True)
class HeightConfig:
    """Wheel-contact height interpolation."""

    robot_height: float = 1.45
    x_wheel_dist: float = 0.5
    y_wheel_dist: float = 0.5
    max_nn_dist_sq: float = 9.0
    min_corr_points: int = 4
    source: str = "cloud"                # "cloud" | "grid"


@dataclasses.dataclass(frozen=True)
class MlsConfig:
    """MLS / occupancy grid."""

    size_x: int = 200
    size_y: int = 200
    resolution: float = 0.2              # [m/cell]
    rolling: bool = True
    max_clusters: int = 4
    min_cluster_points: float = 3.0
    max_cluster_points: float = 20.0
    occupancy_increment: float = 1.0
    occupancy_decrement: float = 0.3
    cluster_sigma_factor: float = 3.0
    cluster_dist_threshold: float = 0.5
    cluster_combine_dist: float = 0.25
    drive_dist_threshold: float = 1.0
    height_threshold: float = 0.4
    normal_threshold: float = 0.15
    robot_height: float = 1.45
    max_range: float = 30.0
    update_dist: int = 100               # update window half-extent [cells]
    min_var_z: float = 0.001


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph SLAM."""

    max_nodes: int = 64
    max_edges: int = 320
    keyframe_points: int = 1024
    knn_dist_thresh: float = 5.0
    knn_edges: int = 3
    min_keyframe_points: int = 0
    opt_iterations: int = 10
    opt_min_delta: float = 1e-5
    edge_icp_voxel: float = 0.5
    edge_max_corr: float = 0.75
    edge_min_corr: int = 5
    edge_icp_max_iter: int = 50
    dist_move_thresh: float = 10.0
    rot_move_thresh: float = 0.2
    lm_lambda: float = 1e-4
    loop_rate_hz: float = 10.0
    evict_degree_weight: float = 0.5
    evict_protect_recent: int = 1
    engine: str = "se2z"                 # "se2z" | "se3"
    edge_registration: str = "2d"        # "2d" | "3d"
    map_regen: str = "voxel"             # "voxel" | "mls" | "grid"
    regen_grid_bins: int = 384
    reloc_info_xy: float = 1000.0
    reloc_info_yaw: float = 100.0


@dataclasses.dataclass(frozen=True)
class GlobalMatchConfig:
    """Correlative relocalization."""

    num_restarts: int = 20
    search_radius: float = 10.0
    accept_score: float = 0.35           # match-fraction lower bound
    max_failures: int = 50
    voxel_leaf: float = 1.5
    num_rotations: int = 64
    grid_size: int = 256
    grid_resolution: float = 0.5
    smooth_radius: int = 2
    rot_chunk: int = 8


@dataclasses.dataclass(frozen=True)
class PfConfig:
    """Particle-filter scan matching (BASELINE config 5's matcher)."""

    num_particles: int = 128
    pos_sigma: float = 0.3               # proposal spread around pred [m]
    yaw_sigma: float = 0.05              # [rad]
    temperature: float = 0.1             # softmax temperature on hit fractions
    min_score: float = 0.2               # acceptance gate (hit fraction)
    # score every k-th scan point: the hit fraction stays unbiased, with
    # more sampling noise; config 5's fleet uses 4
    score_stride: int = 1
    # "auto" | "pallas" | "kernel" (kernel K5 on the card), "gather" |
    # "dense" (the plain version); every engine gives the same scores
    scorer: str = "auto"


@dataclasses.dataclass(frozen=True)
class SampleMapConfig:
    """Sample-probability grid."""

    size_x: int = 400
    size_y: int = 400
    resolution: float = 0.5
    prob_min: float = 0.0
    prob_max: float = 5.0
    fov_cone: float = math.pi / 2
    r_min: float = 1.0
    r_max: float = 10.0
    pixel_prob_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    """Fixed-capacity masked point-cloud containers."""

    scan_capacity: int = 2048
    scene_capacity: int = 1024
    ground_capacity: int = 1024
    map_capacity: int = 4096
    min_scan_points: int = 0
    scene_builder: str = "auto"          # "incidence" | "grid" | "auto"
    # slam_tpu's map export takes approx_max_k below 1.0, a TPU partial
    # reduction that drops some cells; off the TPU it equals the exact
    # top-k. The port's export is always the exact top-k (a stable sort),
    # so this knob is accepted and has no effect.
    export_recall: float = 0.8


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Synthetic world and sensor simulation."""

    world_extent: float = 60.0           # half-extent [m]
    num_obstacles: int = 48
    obstacle_radius_min: float = 0.4
    obstacle_radius_max: float = 1.6
    num_beams: int = 360                 # 2D lidar beams
    beam_max_range: float = 50.0
    range_noise: float = 0.01            # [m] 1-sigma
    gyro_noise: float = 0.002            # [rad/s]
    gyro_bias: float = 0.01              # [rad/s]
    imu_pitch_bias: float = 0.0          # [rad]
    num_rings: int = 32
    ring_elevation_min: float = -0.535
    ring_elevation_max: float = 0.186
    num_azimuth: int = 64
    sensor_height: float = 1.45
    dt: float = 0.1                      # [s]


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level config tree."""

    ekf: EkfConfig = _fd(default_factory=EkfConfig)
    ground: GroundSegConfig = _fd(default_factory=GroundSegConfig)
    icp: IcpConfig = _fd(default_factory=IcpConfig)
    height: HeightConfig = _fd(default_factory=HeightConfig)
    mls: MlsConfig = _fd(default_factory=MlsConfig)
    graph: GraphConfig = _fd(default_factory=GraphConfig)
    global_match: GlobalMatchConfig = _fd(default_factory=GlobalMatchConfig)
    sample_map: SampleMapConfig = _fd(default_factory=SampleMapConfig)
    pf: PfConfig = _fd(default_factory=PfConfig)
    cloud: CloudConfig = _fd(default_factory=CloudConfig)
    sim: SimConfig = _fd(default_factory=SimConfig)
    dtype: str = "float32"

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> SlamConfig:
    return SlamConfig()


def sim2d_config() -> SlamConfig:
    """The 2D 360-beam simulation (BASELINE config 1; config 5 with
    icp.matcher="particle")."""
    c = SlamConfig()
    return dataclasses.replace(
        c,
        icp=dataclasses.replace(c.icp, max_points=512, inlier_dist=1.0,
                                crop_dist=55.0, ga_num_bins=192),
        cloud=dataclasses.replace(c.cloud, scan_capacity=512,
                                  scene_capacity=384, ground_capacity=8,
                                  map_capacity=512),
        mls=dataclasses.replace(c.mls, size_x=192, size_y=192, resolution=0.5,
                                max_range=50.0, update_dist=96),
    )


def sim2d_graph_config() -> SlamConfig:
    """BASELINE config 4, 2D graph SLAM, at the shapes slam_tpu's benchmark
    runs it (bench.py's bench_graph): sim2d_config with a graph of 32
    keyframes of 384 points and 128 edges, the target regenerated by the
    "grid" engine on 256 x 256 cells; engine "se2z", edge_registration
    "2d"."""
    c = sim2d_config()
    return dataclasses.replace(c, graph=dataclasses.replace(
        c.graph, max_nodes=32, max_edges=128, keyframe_points=384,
        map_regen="grid", regen_grid_bins=256))


def sim2d_reloc_config() -> SlamConfig:
    """BASELINE config 3, MLS mapping with FFT relocalization, at the shapes
    slam_tpu's benchmark runs it (bench.py's bench_mls_reloc): sim2d_config
    with a 192 x 192 search raster and 32 rotations (chunks of 8)."""
    c = sim2d_config()
    return dataclasses.replace(c, global_match=dataclasses.replace(
        c.global_match, grid_size=192, num_rotations=32))


def ref_scale_config() -> SlamConfig:
    """3D Velodyne at the reference's own working point: 32 x 640 rays,
    the full 72 x 200 ground grid to 100 m, up to 20k model points per
    class, 384-cell grids at 0.5 m."""
    c = SlamConfig()
    return dataclasses.replace(
        c,
        sim=dataclasses.replace(c.sim, num_azimuth=640, beam_max_range=100.0),
        ground=dataclasses.replace(c.ground, signal_capacity=64),
        height=dataclasses.replace(c.height, source="grid"),
        graph=dataclasses.replace(c.graph, edge_min_corr=30),
        icp=dataclasses.replace(c.icp, inlier_dist=5.0, max_points=20000,
                                ga_num_bins=384),
        cloud=dataclasses.replace(c.cloud, scan_capacity=20480,
                                  scene_capacity=4096,
                                  ground_capacity=20480,
                                  map_capacity=40960,
                                  min_scan_points=5856,
                                  scene_builder="grid"),
        mls=dataclasses.replace(c.mls, size_x=384, size_y=384, resolution=0.5,
                                max_range=100.0, update_dist=192),
    )


def sim3d_config() -> SlamConfig:
    """The 3D Velodyne simulation (BASELINE config 2): 32 rings x 64
    azimuths, sector and bin counts scaled down to match."""
    c = SlamConfig()
    return dataclasses.replace(
        c,
        ground=dataclasses.replace(c.ground, num_sectors=16, num_range_bins=32,
                                   signal_capacity=32, min_bin_points=2,
                                   r_max=60.0, max_insac_sweeps=8),
        icp=dataclasses.replace(c.icp, max_points=512, inlier_dist=1.0,
                                crop_dist=55.0, ga_num_bins=192),
        cloud=dataclasses.replace(c.cloud, scan_capacity=2048,
                                  scene_capacity=256, ground_capacity=1536,
                                  map_capacity=512),
        mls=dataclasses.replace(c.mls, size_x=192, size_y=192, resolution=0.5,
                                max_range=50.0, update_dist=96),
    )


def ref_scale_graph_config() -> SlamConfig:
    """Config 4 in 3D at the reference's working point, as slam_tpu's long
    mission builds it (bench.py's bench_ref_scale_longrun):
    ref_scale_config with 64 keyframes of 2,048 points, 320 edges,
    edge_min_corr 30 (a mis-posed keyframe's few bogus correspondences
    cannot pass it) and the 192-cell, 64-rotation relocalization search;
    engine "se2z" over planar edges."""
    c = ref_scale_config()
    return dataclasses.replace(
        c, graph=dataclasses.replace(c.graph, max_nodes=64, max_edges=320,
                                     keyframe_points=2048, edge_min_corr=30),
        global_match=dataclasses.replace(c.global_match, grid_size=192,
                                         num_rotations=64))


def sim3d_se3_config() -> SlamConfig:
    """Config 4 in 3D with the reference's literal 6-DoF chain at sim3d
    (the shapes of bench.py's bench_3d): engine "se3" over 3D ICP edges
    with 6 x 6 LUM information, the GraphConfig capacities (64 keyframes
    of 1,024 points, 320 edges) and a 2.5 m keyframe gate, the gate
    tests/test_graph_se3_edges.py and tests/test_pipeline3d_graph.py run
    it at."""
    c = sim3d_config()
    return dataclasses.replace(c, graph=dataclasses.replace(
        c.graph, engine="se3", edge_registration="3d", knn_dist_thresh=2.5))


def apply_sweep_overrides(cfg: SlamConfig,
                          spec: str | None = None) -> SlamConfig:
    """Apply dotted-path overrides from a sweep spec onto the frozen config
    tree: "icp.loop=while;cloud.export_recall=1.0". `spec` defaults to the
    SLAM_TPU_SWEEP_SET environment variable (the variable slam_tpu's
    sweeps set, so one spec configures both packages). Values are coerced
    to the type of the field they replace; unknown paths raise."""
    import os
    if spec is None:
        spec = os.environ.get("SLAM_TPU_SWEEP_SET", "")
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        path, _, raw = item.partition("=")
        parts = path.split(".")
        nodes = [cfg]
        for p in parts[:-1]:
            nodes.append(getattr(nodes[-1], p))
        old = getattr(nodes[-1], parts[-1])
        if isinstance(old, bool):
            val: object = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        else:
            val = raw
        for node, name in zip(reversed(nodes), reversed(parts)):
            val = dataclasses.replace(node, **{name: val})
        cfg = val
    return cfg
