"""3D Velodyne fleet SLAM, BASELINE config 2 — counterpart of
slam_tpu/pipeline/slam3d.py for the scan-to-map path.

One tick (slam_step_3d) runs: drive on the terrain and cast the tilted
ring scan -> IMU roll / pitch compensation -> EKF predict + gyro update ->
GP-INSAC ground segmentation -> obstacle scene (compaction, ground
adjacency and pairwise voxels for small scans, the scatter-to-grid builder
for reference-scale scans) -> registration (kernel K1, or K3 above
RESIDENT_TILE_LIMIT, for matcher "fused"; icp_fit on kernel K4 for
"points"; for "grid" the nearest-centroid field of the obstacle point map,
ops/grid_icp.py, in plain PyTorch) -> EKF SLAM update -> wheel-contact
height interpolation -> obstacle and ground point maps -> occupancy, and
the metrics ring when the state carries one. Every function takes and
returns the whole robot batch; the scan-completeness gate is a tensor op,
so a tick never waits for the card.

Graph mode (`rollout_3d_with_graph`, config 4 in 3D): the ticks register
against the target regenerated from the pose graph's keyframes, with
ground adjacency re-classified around the prediction, and leave the
obstacle point map alone; every graph tick (slam2d.graph_update_delta)
adds keyframes, optimises and regenerates, and the newest node's z offset
shifts the ground map (`apply_graph_offset`). Planar edges (K2, or K3
above RESIDENT_TILE_LIMIT) or 6-DoF edges (ops/icp3d.py, with the ground
sample the state carries in prev_ground) per cfg.graph.

On a CPU tensor each kernel's plain PyTorch version runs; "fused" is never
swapped for "points". Graph mode registers "grid" as "points", as
slam_tpu does: the field reads the obstacle grid, which graph mode does
not keep.

`GroundMap` (types.py) is importable from here, as slam_tpu defines it
here; `build_scene_3d` is the cloud-out form of `build_scene_3d_planes`.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.geometry import rp_compensate, se2_apply_xy
from slam_tpu_torch.mapping.occupancy import (add_to_occupancy_xy2,
                                              shift_origin)
from slam_tpu_torch.mapping.point_map import (export_point_planes,
                                              export_points, init_point_map,
                                              offset_point_map_z,
                                              shift_point_map,
                                              update_point_map_xy)
from slam_tpu_torch.models import ekf as ekf_mod
from slam_tpu_torch.ops.classify import classify_ga_planes
from slam_tpu_torch.ops.grid_icp import icp_fit_grid, nearest_point_field
from slam_tpu_torch.ops.ground import segment_ground, split_ground_obstacle
from slam_tpu_torch.ops.height import (height_interpolate,
                                       height_interpolate_grid,
                                       height_interpolate_planes)
from slam_tpu_torch.ops.icp import icp_fit
from slam_tpu_torch.ops.icp_fused import fused_register
from slam_tpu_torch.ops.scene_grid import build_scene_grid_planes
from slam_tpu_torch.ops.voxel import (compact_planes, crop_box,
                                      voxel_downsample_pairwise_planes)
from slam_tpu_torch.parallel.rows import refuse
from slam_tpu_torch.pipeline.slam2d import (graph_update_delta, init_state,
                                            planes_to_cloud)
from slam_tpu_torch.sim import world2d, world3d
from slam_tpu_torch.types import GroundMap, PointCloud, cloud_from_xyz, \
    make_cloud
from slam_tpu_torch.utils import metrics

MATCHERS = ("fused", "points", "grid")


def init_state_3d(cfg, batch: int, world: world3d.World3D, device=None,
                  generator: torch.Generator | None = None,
                  with_graph: bool = False):
    """init_state with z anchored at the true sensor height over the start
    point (the estimated z drifts from there), and a zero IMU attitude.
    with_graph: graph mode, an empty pose graph, no obstacle point-map grid
    (graph mode registers against the regenerated keyframe map and never
    reads or writes one; slam_tpu allocates it only to keep its pytree's
    shape, and interop carries either), and for 6-DoF edges an empty
    ground sample of keyframe_points slots."""
    s = init_state(cfg, batch, device=device, generator=generator,
                   with_graph=with_graph)
    if with_graph and cfg.graph.edge_registration == "3d":
        s = s.replace(prev_ground=make_cloud(batch, cfg.graph.keyframe_points,
                                             device=s.pose.device))
    z0 = world3d.terrain_height(world, torch.zeros(2, device=s.pose.device)) \
        + cfg.sim.sensor_height
    pose = s.pose.clone()
    pose[:, 3] = z0
    true_pose = s.true_pose.clone()
    true_pose[:, 3] = z0
    return s.replace(pose=pose, true_pose=true_pose,
                     attitude=torch.zeros(batch, 2, device=s.pose.device))


def init_ground_map(cfg, batch: int, device=None) -> GroundMap:
    """Empty ground stores. With grid-direct height interpolation the
    exported ground cloud is never read, so it is a stub of 8 slots."""
    cap = 8 if cfg.height.source == "grid" else cfg.cloud.map_capacity
    return GroundMap(grid=init_point_map(batch, cfg.mls.size_x,
                                         cfg.icp.voxel_leaf_obs[0],
                                         device=device),
                     cloud=make_cloud(batch, cap, device=device))


def build_scene_3d_planes(scan_xyz: torch.Tensor, hit: torch.Tensor, cfg):
    """Segment upright scans (B, N, 3) and build the obstacle scene.

    Returns obstacle planes (ox, oy, oz, oga, odrv, ovalid), capacity
    cfg.cloud.scene_capacity, and ground planes (gx, gy, gz, gvalid) in scan
    slots. Builder "incidence" (the default, "auto", up to 4096 points)
    compacts the obstacles, flags ground adjacency and voxel-downsamples;
    "grid" (above) scatters them into a scan-local centroid grid. The
    ground class is not downsampled: its consumers re-bin it."""
    seg = segment_ground(cloud_from_xyz(scan_xyz, valid=hit), cfg.ground)
    obstacle, ground, _ = split_ground_obstacle(seg.cloud)
    x, y, z = scan_xyz.unbind(-1)
    drv = ((seg.cloud.flags & PointCloud.FLAG_DRIVABLE) != 0).to(x.dtype)
    builder = cfg.cloud.scene_builder
    if builder == "auto":
        builder = "grid" if x.shape[-1] > 4096 else "incidence"
    if builder == "grid":
        ox, oy, oz, oga, odrv, okeep = build_scene_grid_planes(
            x, y, z, obstacle, drv, cfg.cloud.scene_capacity,
            cfg.icp.ga_resolution, cfg.icp.scan_grid_bins,
            cfg.icp.ga_threshold)
        return (ox, oy, oz, oga, odrv, okeep), (x, y, z, ground)
    (ox, oy, oz, odrv), ovalid = compact_planes((x, y, z, drv), obstacle,
                                                cfg.cloud.scene_capacity)
    oga = classify_ga_planes(ox, oy, ovalid, torch.zeros_like(ox[:, :2]),
                             cfg.icp.ga_num_bins, cfg.icp.ga_resolution,
                             cfg.icp.ga_threshold)
    (ox, oy, oz), okeep, (oga, odrv) = voxel_downsample_pairwise_planes(
        ox, oy, oz, ovalid, (oga.to(x.dtype), odrv), cfg.icp.voxel_leaf_obs)
    return (ox, oy, oz, oga, odrv, okeep), (x, y, z, ground)


def build_scene_3d(scan_xyz: torch.Tensor, hit: torch.Tensor, cfg):
    """build_scene_3d_planes with clouds out: (obstacle scene, ground
    cloud), the ground compacted to cfg.cloud.ground_capacity slots."""
    (ox, oy, oz, oga, odrv, ovalid), (gx, gy, gz, gvalid) = \
        build_scene_3d_planes(scan_xyz, hit, cfg)
    obs = _planes_to_cloud_3d(ox, oy, oz, oga, odrv, ovalid)
    (gx, gy, gz), gvalid = compact_planes((gx, gy, gz), gvalid,
                                          cfg.cloud.ground_capacity)
    gnd = PointCloud(
        xyz=torch.where(gvalid[..., None], torch.stack([gx, gy, gz], -1),
                        0.0),
        valid=gvalid,
        flags=torch.where(gvalid, PointCloud.FLAG_GROUND, 0).to(torch.int32))
    return obs, gnd


def _reclassified_target_planes(map_cloud: PointCloud, pred, cfg):
    """(mpx, mpy, mga, mvalid) of a graph-regenerated target, its ground
    adjacency re-evaluated around the prediction pred (B, 3): the
    keyframes' capture-time flags go stale after optimisation and
    merging."""
    mpx = map_cloud.xyz[..., 0]
    mpy = map_cloud.xyz[..., 1]
    mga = classify_ga_planes(mpx, mpy, map_cloud.valid, pred[:, :2],
                             cfg.icp.ga_num_bins, cfg.icp.ga_resolution,
                             cfg.icp.ga_threshold)
    return mpx, mpy, mga, map_cloud.valid


def _ground_sample(gx, gy, gz, gvalid, capacity: int) -> PointCloud:
    """Every (N // capacity)-th ground slot (beam order: even angular and
    ring coverage), compacted into `capacity` slots, in the robot frame."""
    stride = max(1, gx.shape[-1] // capacity)
    (px, py, pz), valid = compact_planes(
        (gx[:, ::stride], gy[:, ::stride], gz[:, ::stride]),
        gvalid[:, ::stride], capacity)
    return PointCloud(
        xyz=torch.where(valid[..., None], torch.stack([px, py, pz], -1), 0.0),
        valid=valid,
        flags=torch.where(valid, PointCloud.FLAG_GROUND, 0).to(torch.int32))


def _planes_to_cloud_3d(px, py, pz, ga, drv, valid) -> PointCloud:
    xyz = torch.where(valid[..., None], torch.stack([px, py, pz], -1), 0.0)
    flags = torch.where(ga, PointCloud.FLAG_GA, 0) | \
        torch.where(drv, PointCloud.FLAG_DRIVABLE, 0)
    return PointCloud(xyz=xyz, valid=valid,
                      flags=torch.where(valid, flags, 0).to(torch.int32))


def process_frame_3d(state, ground_map: GroundMap, scan_tilted, hit, roll,
                     pitch, gyro, cmd, cfg, refresh_map: bool = True,
                     shift_maps: bool = True, target_planes=None,
                     field=None, incremental_map: bool = True):
    """Sensor frames -> updated (state, ground_map). scan_tilted (B, N, 3)
    in the tilted sensor frame, hit (B, N), measured roll / pitch (B,), raw
    gyro z (B,), commanded body velocity cmd (B, 3).

    target_planes: optional (mx, my, mga, mvalid) registration target that
    the rollout refreshes once per macro; None registers against
    state.map_cloud. field: the grid matcher's NearestField, which the
    rollout builds once per macro; None builds it from state.map_grid.
    refresh_map re-exports the targets after the update; shift_maps
    re-centres the rolling grids on the fused pose.

    incremental_map False is graph mode: registration targets only the
    graph-regenerated state.map_cloud, its ground adjacency re-classified
    around the prediction, and the obstacle point map is left as it is;
    the ground map and occupancy update as always. A state that carries
    prev_ground gets this frame's strided ground sample there. Not ported
    to grids split by rows: raises NotImplementedError there."""
    for g in (state.local_map, state.map_grid, ground_map.grid):
        refuse(g, "the 3D path", "3D, with mesh_scaling --sp")
    matcher = cfg.icp.matcher
    if matcher not in MATCHERS:
        raise ValueError(f"unknown 3D icp.matcher {matcher!r} (have "
                         f"{MATCHERS}; particle is 2D-only)")
    if not incremental_map and matcher == "grid":
        # the nearest-centroid field reads the obstacle grid, which graph
        # mode does not keep
        matcher = "points"
    dt = cfg.sim.dt

    # non-finite points are misses; an incomplete scan masks every point
    # (registration fails, the EKF dead-reckons, the maps stay)
    hit = hit & torch.isfinite(scan_tilted).all(-1)
    if cfg.cloud.min_scan_points > 0:
        hit = hit & (hit.sum(-1, keepdim=True) >= cfg.cloud.min_scan_points)
    roll = torch.where(torch.isfinite(roll), roll, 0.0)
    pitch = torch.where(torch.isfinite(pitch), pitch, 0.0)
    scan_xyz = rp_compensate(torch.where(hit[..., None], scan_tilted, 0.0),
                             roll, pitch)

    ekf = ekf_mod.motion_update(state.ekf, cmd, dt, cfg.ekf)
    ekf = ekf_mod.yaw_rate_update(ekf, gyro, cfg.ekf)
    pred = ekf_mod.pose_xyyaw(ekf)

    (ox, oy, oz, oga, odrv, ovalid), (gx, gy, gz, gvalid) = \
        build_scene_3d_planes(scan_xyz, hit, cfg)
    if matcher == "grid":
        if field is None:
            field = nearest_point_field(state.map_grid,
                                        cfg.icp.voxel_leaf_obs[0],
                                        cfg.icp.ga_threshold)
        icp = icp_fit_grid(torch.stack([ox, oy], -1), ovalid, oga, field,
                           pred, cfg.icp)
    elif matcher == "fused":
        if not incremental_map:
            target_planes = _reclassified_target_planes(state.map_cloud,
                                                        pred, cfg)
        icp = fused_register(ox, oy, ovalid, oga, target_planes,
                             state.map_cloud, pred, cfg.icp)
    elif not incremental_map:
        target = crop_box(state.map_cloud, pred[:, :2], cfg.icp.crop_dist)
        mpx, mpy, mga, mvalid = _reclassified_target_planes(state.map_cloud,
                                                            pred, cfg)
        icp = icp_fit(torch.stack([ox, oy], -1), ovalid, oga,
                      torch.stack([mpx, mpy], -1), target.valid & mvalid,
                      mga, pred, cfg.icp)
    else:
        target = crop_box(state.map_cloud, pred[:, :2], cfg.icp.crop_dist)
        icp = icp_fit(torch.stack([ox, oy], -1), ovalid, oga,
                      target.xyz[..., :2], target.valid, target.is_ga(),
                      pred, cfg.icp)

    scene_points = ovalid.sum(-1)
    metrics.emit("slam_step_3d", icp_ok=icp.ok, num_corr=icp.num_corr,
                 mean_residual=icp.mean_residual, scene_points=scene_points)
    ring = metrics.ring_write(state.metrics_ring, site="slam_step_3d",
                              step=state.step, icp_ok=icp.ok,
                              num_corr=icp.num_corr,
                              mean_residual=icp.mean_residual,
                              scene_points=scene_points)
    ekf = ekf_mod.slam_update(ekf, icp.pose, cfg.ekf, has_meas=icp.ok)
    fused = ekf_mod.pose_xyyaw(ekf)
    z_prev = state.pose[:, 3:4]
    pose4_pre = torch.cat([fused, z_prev], -1)
    map_pose = torch.cat([torch.where(icp.ok[:, None], icp.pose, pred),
                          z_prev], -1)
    if cfg.height.source == "grid":
        new_z = height_interpolate_grid(ground_map.grid, pose4_pre,
                                        cfg.height)
        have_map = (ground_map.grid.count >= 1.0).sum((1, 2)) >= \
            cfg.height.min_corr_points
    else:
        new_z = height_interpolate(ground_map.cloud, pose4_pre, cfg.height)
        have_map = ground_map.cloud.valid.sum(-1) >= \
            cfg.height.min_corr_points
    # with no ground map yet, this scan's own ground points at the pose
    gwx, gwy = se2_apply_xy(map_pose[:, :3], gx, gy)
    z_scan = height_interpolate_planes(gwx, gwy, gz + map_pose[:, 3:4],
                                       gvalid, pose4_pre, cfg.height)
    z = torch.where(have_map, new_z, z_scan)[:, None]
    pose4 = torch.cat([fused, z], -1)
    map_pose = torch.cat([map_pose[:, :3], z], -1)
    gwz = gz + z

    res = cfg.icp.voxel_leaf_obs[0]
    mg = state.map_grid
    if incremental_map:
        owx, owy = se2_apply_xy(map_pose[:, :3], ox, oy)
        if shift_maps:
            mg = shift_point_map(mg, fused[:, :2], res)
        mg = update_point_map_xy(mg, owx, owy, oz + z, ovalid, res)
    gg = shift_point_map(ground_map.grid, fused[:, :2], res) \
        if shift_maps else ground_map.grid
    gg = update_point_map_xy(gg, gwx, gwy, gwz, gvalid, res)
    map_cloud, gnd_cloud = state.map_cloud, ground_map.cloud
    if refresh_map and incremental_map:
        map_cloud = export_points(mg, map_cloud.capacity,
                                  ga_threshold=cfg.icp.ga_threshold)
        if cfg.height.source != "grid":
            gnd_cloud = export_points(gg, gnd_cloud.capacity)

    grid = shift_origin(state.local_map, fused[:, :2], cfg.mls) \
        if shift_maps else state.local_map
    rel = torch.stack([fused[:, 0] - grid.center[:, 0],
                       fused[:, 1] - grid.center[:, 1], fused[:, 2]], -1)
    olx, oly = se2_apply_xy(rel, ox, oy)
    glx, gly = se2_apply_xy(rel, gx, gy)
    grid = add_to_occupancy_xy2(grid, olx, oly, ovalid & ~odrv, glx, gly,
                                gvalid, cfg.mls)

    # both scene builders fill cfg.cloud.scene_capacity slots, the
    # capacity of state.prev_scene
    prev_scene = _planes_to_cloud_3d(ox, oy, oz, oga, odrv, ovalid)
    prev_ground = state.prev_ground
    if prev_ground is not None:
        prev_ground = _ground_sample(gx, gy, gz, gvalid,
                                     prev_ground.capacity)
    new_state = state.replace(
        ekf=ekf, pose=pose4, scan_reg_pose=map_pose, scan_reg_ok=icp.ok,
        local_map=grid, prev_scene=prev_scene, map_cloud=map_cloud,
        map_grid=mg, step=state.step + 1, metrics_ring=ring,
        attitude=(None if state.attitude is None
                  else torch.stack([roll, pitch], -1)),
        prev_ground=prev_ground)
    return new_state, GroundMap(grid=gg, cloud=gnd_cloud)


def slam_step_3d_io(state, ground_map: GroundMap, scan_tilted, hit, roll,
                    pitch, gyro, cmd, cfg, refresh_map: bool = True,
                    shift_maps: bool = True, field=None):
    """A tick driven by external sensor frames (replay, live transport or
    oracle comparison); the arguments are process_frame_3d's."""
    return process_frame_3d(state, ground_map, scan_tilted, hit, roll, pitch,
                            gyro, cmd, cfg, refresh_map=refresh_map,
                            shift_maps=shift_maps, field=field)


def slam_step_3d(state, world: world3d.World3D, ground_map: GroundMap, cfg,
                 generator: torch.Generator | None = None,
                 refresh_map: bool = True, shift_maps: bool = True,
                 target_planes=None, field=None,
                 incremental_map: bool = True):
    """One simulated tick: drive on the terrain, sense (the robot tilts
    with the surface; range and IMU noise drawn from `generator`, none
    without one), then process the frame. Returns (state, ground_map)."""
    dt = cfg.sim.dt
    cmd = ekf_mod.clamp_cmd(world2d.drive_cmd(state.step, dt), cfg.ekf)
    true2 = world2d.unicycle_step(state.true_pose[:, :3], cmd, dt)
    true_z = world3d.terrain_height(world, true2[:, :2]) + cfg.sim.sensor_height
    roll, pitch = world3d.terrain_attitude(world, true2[:, :2])
    scan, hit = world3d.raycast(world, true2, cfg.sim, generator=generator,
                                roll=roll, pitch=pitch)
    imu = torch.zeros_like(true2) if generator is None else \
        cfg.sim.gyro_noise * torch.randn(true2.shape, generator=generator,
                                         device=true2.device)
    gyro = cmd[:, 2] + cfg.sim.gyro_bias + imu[:, 2]
    state, gm = process_frame_3d(
        state, ground_map, scan, hit, roll + imu[:, 0],
        pitch + imu[:, 1] + cfg.sim.imu_pitch_bias, gyro, cmd, cfg,
        refresh_map=refresh_map, shift_maps=shift_maps,
        target_planes=target_planes, field=field,
        incremental_map=incremental_map)
    return state.replace(true_pose=torch.cat([true2, true_z[:, None]], -1)), gm


def rollout_3d(state, world: world3d.World3D, ground_map: GroundMap, cfg,
               num_steps: int, generator: torch.Generator | None = None,
               field_every: int = 4):
    """Run num_steps ticks, rounded up to whole macros of field_every.

    Each macro re-centres the rolling grids once, exports the registration
    target from the obstacle point map (the grid matcher builds its
    nearest-centroid field from the re-centred grid instead) and, for
    cfg.height.source "cloud", the ground cloud once; its ticks then
    register against that target and skip the shifts. Returns (final
    state, final ground map, (est, true, reg_ok)): trajectories (B,
    num_steps, 4) [x, y, yaw, z] and each tick's registration flag (B,
    num_steps) (slam_tpu returns the first two). Under metrics.nan_debug
    the state and ground map are checked finite after every tick."""
    num_macro = -(-num_steps // field_every)
    s, gm = state, ground_map
    est, true, reg_ok = [], [], []
    for _ in range(num_macro):
        s = s.replace(map_grid=shift_point_map(s.map_grid, s.pose[:, :2]),
                      local_map=shift_origin(s.local_map, s.pose[:, :2],
                                             cfg.mls))
        gm = gm.replace(grid=shift_point_map(gm.grid, s.pose[:, :2]))
        planes = field = None
        if cfg.icp.matcher == "grid":
            field = nearest_point_field(s.map_grid, cfg.icp.voxel_leaf_obs[0],
                                        cfg.icp.ga_threshold)
        else:
            ex, ey, ez, ega, evalid = export_point_planes(
                s.map_grid, s.map_cloud.capacity,
                ga_threshold=cfg.icp.ga_threshold)
            planes = (ex, ey, ega, evalid)
            s = s.replace(map_cloud=planes_to_cloud(ex, ey, ega, evalid, ez))
        if cfg.height.source != "grid":
            gm = gm.replace(cloud=export_points(gm.grid, gm.cloud.capacity))
        for _ in range(field_every):
            s, gm = slam_step_3d(s, world, gm, cfg, generator,
                                 refresh_map=False, shift_maps=False,
                                 target_planes=planes, field=field)
            metrics.check_finite(len(est), state=s, ground_map=gm)
            est.append(s.pose)
            true.append(s.true_pose)
            reg_ok.append(s.scan_reg_ok)
    return s, gm, tuple(torch.stack(t, 1)[:, :num_steps]
                        for t in (est, true, reg_ok))


def apply_graph_offset(gm: GroundMap, delta: torch.Tensor) -> GroundMap:
    """The graph's pose offset applied to the ground store (MLS::offsetMap):
    every stored point's z, in the grid and in the exported cloud that
    shadows it between macros, shifts by delta[:, 3] (B,), so the next
    height interpolation reads the corrected surface. x, y and yaw are
    not applied, as in the reference."""
    dz = delta[:, 3]
    cloud = gm.cloud
    z = cloud.xyz[..., 2] + torch.where(cloud.valid, dz[:, None], 0.0)
    return GroundMap(grid=offset_point_map_z(gm.grid, dz),
                     cloud=cloud.replace(xyz=torch.cat(
                         [cloud.xyz[..., :2], z[..., None]], -1)))


def rollout_3d_with_graph(state, world: world3d.World3D,
                          ground_map: GroundMap, cfg, num_macro: int,
                          generator: torch.Generator | None = None,
                          graph_every: int = 8):
    """The 3D stack with the pose graph in the loop: num_macro macros, each
    one re-centring of the ground map and the occupancy grid (and, for
    cfg.height.source "cloud", one ground export), graph_every ticks in
    graph mode (incremental_map=False) and a graph tick, whose newest-node
    z offset shifts the ground map. Returns (final state, final ground
    map, (est, true)), trajectories (B, num_macro * graph_every, 4)."""
    s, gm = state, ground_map
    est, true = [], []
    for _ in range(num_macro):
        if cfg.height.source != "grid":
            gm = gm.replace(cloud=export_points(gm.grid, gm.cloud.capacity))
        gm = gm.replace(grid=shift_point_map(gm.grid, s.pose[:, :2]))
        s = s.replace(local_map=shift_origin(s.local_map, s.pose[:, :2],
                                             cfg.mls))
        for _ in range(graph_every):
            s, gm = slam_step_3d(s, world, gm, cfg, generator,
                                 refresh_map=False, shift_maps=False,
                                 incremental_map=False)
            est.append(s.pose)
            true.append(s.true_pose)
        s, delta = graph_update_delta(s, cfg)
        gm = apply_graph_offset(gm, delta)
    return s, gm, (torch.stack(est, 1), torch.stack(true, 1))
