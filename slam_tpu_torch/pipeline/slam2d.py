"""2D fleet SLAM, BASELINE configs 1, 4 and 5 — counterpart of
slam_tpu/pipeline/slam2d.py.

One tick (slam_step) runs: raycast -> EKF predict + gyro update -> scene
build -> registration (kernel K1 for matcher "fused", icp_fit on kernel K4
for "points", the particle filter on kernel K5 for "particle") -> EKF SLAM
update -> point-map update -> occupancy update, and writes the metrics
ring when the state carries one; the "grid" matcher (ops/grid_icp.py)
fits against a nearest-centroid field of the point-map grid, built once a
macro, in plain PyTorch. Every function takes and returns the whole robot
batch. `register_scan_to_scan` registers against the previous scene
(kernel K2 for "fused").

Graph mode (config 4, `rollout_with_graph`): the ticks register against a
target regenerated from the pose graph's keyframes, and every graph tick
(`graph_update`) adds keyframes with edges (planar ones measured by K2),
optimises the graph by graph.engine ("se2z", or "se3": the SE(3) solver
over the lifted planar edges, or over measured 6-DoF edges with
edge_registration "3d") and regenerates the target by graph.map_regen's
engine, "voxel", "mls" or "grid" (graph/pose_graph.py,
graph/pose_graph3d.py). The 3D path's graph mode
(pipeline/slam3d.rollout_3d_with_graph) runs the same graph tick.

Split by rows over an sp group (parallel/rows.py: the grids' `rows`
field), the ticks and `rollout` run unchanged with matchers "fused",
"points" and "particle": every grid op reads the split, and the per-robot
state outside the grids is the same on every rank of the group. The "grid"
matcher and graph mode raise NotImplementedError there.

On a CPU tensor each kernel's plain PyTorch version runs; "fused" is never
swapped for "points".
"""

from __future__ import annotations

import torch

from slam_tpu_torch import default_device, true_div
from slam_tpu_torch.geometry import se2_apply, se2_apply_xy
from slam_tpu_torch.graph import pose_graph as pg
from slam_tpu_torch.graph import pose_graph3d as pg3
from slam_tpu_torch.mapping.occupancy import (add_to_occupancy_xy,
                                              init_occupancy, shift_origin)
from slam_tpu_torch.mapping.point_map import (export_point_planes,
                                              export_points, init_point_map,
                                              shift_point_map,
                                              update_point_map_xy)
from slam_tpu_torch.models import ekf as ekf_mod
from slam_tpu_torch.ops.classify import (classify_ga_planes,
                                         classify_ground_adjacent)
from slam_tpu_torch.ops.grid_icp import icp_fit_grid, nearest_point_field
from slam_tpu_torch.ops.icp import IcpResult, icp_fit
from slam_tpu_torch.ops.icp_fused import fused_register, icp_fused
from slam_tpu_torch.ops.particle import pf_match
from slam_tpu_torch.ops.scatter2d import gather_cells_2d, scatter_add_2d_multi
from slam_tpu_torch.ops.scene_grid import build_scene_grid_planes
from slam_tpu_torch.ops.stencil import neighbor_sum_2d
from slam_tpu_torch.ops.voxel import compact_planes, crop_box, voxel_downsample
from slam_tpu_torch.parallel.rows import refuse
from slam_tpu_torch.sim import world2d
from slam_tpu_torch.types import (PointCloud, SlamState, make_cloud,
                                  select_cloud)
from slam_tpu_torch.utils import metrics

MATCHERS = ("fused", "points", "grid", "particle")


def init_state(cfg, batch: int, device=None,
               generator: torch.Generator | None = None,
               with_graph: bool = False, with_metrics_ring: bool = False,
               metrics_ring_capacity: int = 256) -> SlamState:
    """Fresh fleet state. Each robot's gyro bias is estimated from
    cfg.ekf.num_init_imu_samples stationary samples, drawn from `generator`
    (the robot must not move while they are taken). with_graph: graph mode,
    an empty pose graph and no point-map grid (the target is regenerated
    from keyframes). with_metrics_ring: a device metrics ring of
    metrics_ring_capacity rows per robot. On the card unless `device` says
    otherwise."""
    device = default_device(device)
    noise = torch.randn(batch, cfg.ekf.num_init_imu_samples,
                        generator=generator, device=device)
    bias = ekf_mod.estimate_gyro_bias(cfg.sim.gyro_bias +
                                      cfg.sim.gyro_noise * noise)
    zeros4 = torch.zeros(batch, 4, device=device)
    return SlamState(
        ekf=ekf_mod.init_ekf(cfg.ekf, batch, gyro_bias=bias, device=device),
        pose=zeros4,
        scan_reg_pose=zeros4.clone(),
        scan_reg_ok=torch.zeros(batch, dtype=torch.bool, device=device),
        local_map=init_occupancy(cfg.mls, batch, device=device),
        prev_scene=make_cloud(batch, cfg.cloud.scene_capacity, device=device),
        map_cloud=make_cloud(batch, cfg.cloud.map_capacity, device=device),
        map_grid=None if with_graph else init_point_map(
            batch, cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0], device=device),
        step=torch.zeros(batch, dtype=torch.int32, device=device),
        true_pose=zeros4.clone(),
        graph=pg.init_graph(cfg.graph, batch, device) if with_graph else None,
        graph_full=torch.zeros(batch, dtype=torch.bool, device=device),
        metrics_ring=(metrics.init_ring(batch, metrics_ring_capacity, device)
                      if with_metrics_ring else None),
    )


def build_scene_planes(px: torch.Tensor, py: torch.Tensor, hit: torch.Tensor,
                       cfg, deterministic: bool = False):
    """Scene build for (B, N) scan planes: voxel-downsample at the GA grid's
    resolution and flag ground-adjacent (GA) points. Returns (sx, sy, ga,
    keep) planes of cfg.cloud.scene_capacity slots.

    Builder "grid" (and "auto" above 4,096 points) is the scatter-to-grid
    builder of ops/scene_grid.py on cfg.icp.scan_grid_bins cells: the
    most observed cells, in its order. Otherwise ("incidence", "auto" up
    to 4,096) the first point of a cell keeps the slot, and its centroid
    is the cell centre plus the mean offset of the cell's points from that
    centre; a scan wider than the capacity is compacted, then truncated,
    so that only valid centroids beyond the capacity are dropped. A cell
    is GA when it is interior and has >= ga_threshold empty 8-neighbours.
    (slam_tpu's incidence builder computes the same with same-cell (N, N)
    matmuls; here the cells are scattered and gathered.) `deterministic`:
    sums the same on every run (scatter_add_2d_multi), which the ranks of
    an sp group need to hold the same scene bit for bit."""
    B, N = px.shape
    cap = cfg.cloud.scene_capacity
    builder = cfg.cloud.scene_builder
    if builder == "auto":
        builder = "grid" if N > 4096 else "incidence"
    if builder == "grid":
        sx, sy, _, ga, _, keep = build_scene_grid_planes(
            px, py, None, hit, None, cap, cfg.icp.ga_resolution,
            cfg.icp.scan_grid_bins, cfg.icp.ga_threshold,
            deterministic=deterministic)
        return sx, sy, ga, keep
    res = cfg.icp.ga_resolution
    G = cfg.icp.ga_num_bins
    ci = torch.floor(true_div(px, res)).to(torch.int32) + G // 2
    cj = torch.floor(true_div(py, res)).to(torch.int32) + G // 2
    inb = hit & (ci >= 0) & (cj >= 0) & (ci < G) & (cj < G)
    ccx = (ci.to(px.dtype) - G // 2 + 0.5) * res
    ccy = (cj.to(py.dtype) - G // 2 + 0.5) * res
    relx = torch.where(inb, px - ccx, 0.0)
    rely = torch.where(inb, py - ccy, 0.0)
    counts, sum_x, sum_y = scatter_add_2d_multi(ci, cj, (None, relx, rely),
                                                inb, (G, G),
                                                deterministic=deterministic)

    # first point of each cell keeps the slot
    cell = (ci.clamp(0, G - 1) * G + cj.clamp(0, G - 1)).long()
    n_idx = torch.arange(N, device=px.device).expand(B, N)
    first = torch.full((B, G * G), N, dtype=torch.long, device=px.device)
    first.scatter_reduce_(1, torch.where(inb, cell, 0),
                          torch.where(inb, n_idx, N), reduce="amin")
    keep = inb & (torch.gather(first, 1, cell) == n_idx)

    occ = counts > 0
    box = neighbor_sum_2d((~occ).to(torch.float32))
    ii = torch.arange(G, device=px.device)
    inner = (ii > 0) & (ii < G - 1)
    ga_grid = occ & (inner[:, None] & inner[None, :]) & \
        (box >= cfg.icp.ga_threshold)
    n, ox, oy, g = gather_cells_2d(
        (counts, sum_x, sum_y, ga_grid.to(torch.float32)), ci, cj)
    count = torch.clamp(n, min=1.0)
    sx = ccx + ox / count
    sy = ccy + oy / count
    ga = (g > 0.5) & keep

    if N > cap:
        (sx, sy, gaf), keep = compact_planes((sx, sy, ga.to(sx.dtype)), keep,
                                             cap)
        ga = gaf > 0.5
    else:
        pad = cap - N
        keep = torch.nn.functional.pad(keep, (0, pad))
        ga = torch.nn.functional.pad(ga, (0, pad))
        sx = torch.nn.functional.pad(sx, (0, pad))
        sy = torch.nn.functional.pad(sy, (0, pad))
    sx = torch.where(keep, sx, 0.0)
    sy = torch.where(keep, sy, 0.0)
    return sx, sy, ga, keep


def planes_to_cloud(sx, sy, ga, keep, sz=None) -> PointCloud:
    """Pack (B, N) planes into a PointCloud."""
    z = torch.zeros_like(sx) if sz is None else sz
    flags = torch.where(ga, PointCloud.FLAG_GA, 0).to(torch.int32)
    return PointCloud(xyz=torch.stack([sx, sy, z], -1), valid=keep,
                      flags=flags)


def build_scene(scan_xyz: torch.Tensor, hit: torch.Tensor, cfg) -> PointCloud:
    """build_scene_planes on (B, N, 3) robot-frame scan points, as a
    PointCloud."""
    return planes_to_cloud(*build_scene_planes(scan_xyz[..., 0],
                                               scan_xyz[..., 1], hit, cfg))


def update_map_cloud(map_cloud: PointCloud, scene: PointCloud,
                     pose_xyyaw: torch.Tensor, cfg) -> PointCloud:
    """The map cloud with the scene (B, N) added at pose_xyyaw (B, 3),
    voxel-merged (voxel_downsample at voxel_leaf_obs) into map_capacity
    points: the cloud-level map upkeep (the ticks keep a point-map grid
    instead)."""
    world_xy = se2_apply(pose_xyyaw, scene.xyz[..., :2])
    return voxel_downsample(PointCloud(
        xyz=torch.cat([map_cloud.xyz, torch.cat(
            [world_xy, scene.xyz[..., 2:]], -1)], 1),
        valid=torch.cat([map_cloud.valid, scene.valid], 1),
        flags=torch.cat([map_cloud.flags, scene.flags], 1)),
        cfg.icp.voxel_leaf_obs, cfg.cloud.map_capacity)


def register_scan(scene: PointCloud, map_cloud: PointCloud,
                  init_pose_xyyaw: torch.Tensor, cfg, reclassify: bool = True):
    """Scan-to-map registration with the "points" matcher: crop the map
    around the prediction, re-classify the target's GA flags around it and
    run class-constrained icp_fit. reclassify=False keeps the target's own
    flags (the point map computes them with the same stencil on export)."""
    target = crop_box(map_cloud, init_pose_xyyaw[:, :2], cfg.icp.crop_dist)
    if reclassify:
        target = classify_ground_adjacent(
            target, init_pose_xyyaw[:, :2], cfg.icp.ga_num_bins,
            cfg.icp.ga_resolution, cfg.icp.ga_threshold)
    return icp_fit(scene.xyz[..., :2], scene.valid, scene.is_ga(),
                   target.xyz[..., :2], target.valid, target.is_ga(),
                   init_pose_xyyaw, cfg.icp)


def register_scan_to_scan(scene: PointCloud, prev_scene: PointCloud,
                          prev_pose: torch.Tensor, init_pose: torch.Tensor,
                          cfg) -> IcpResult:
    """Scan-to-scan registration: the previous scene, placed at its pose
    prev_pose (B, >=3), is the model. Returns the scene's absolute pose.
    Matcher "fused" runs K2 (its plain version on CPU tensors); every other
    matcher runs icp_fit."""
    tx, ty = se2_apply_xy(prev_pose[:, :3], prev_scene.xyz[..., 0],
                          prev_scene.xyz[..., 1])
    target_xy = torch.stack([tx, ty], -1)
    args = (scene.xyz[..., :2], scene.valid, scene.is_ga(), target_xy,
            prev_scene.valid, prev_scene.is_ga(), init_pose, cfg.icp)
    return icp_fused(*args) if cfg.icp.matcher == "fused" else icp_fit(*args)


def _pf_register(state, scene, skeep, pred, cfg, pf_target,
                 generator) -> IcpResult:
    """The particle matcher against pf_target (or the robots' own grids),
    as an IcpResult: num_corr = round(score * scene points), delta 0,
    mean_residual 1 - score."""
    r = pf_match(state.map_grid if pf_target is None else pf_target, scene,
                 pred, cfg.icp.voxel_leaf_obs[0], cfg.pf, generator=generator)
    n_valid = skeep.sum(-1)
    return IcpResult(pose=r.pose, ok=r.ok,
                     num_corr=torch.round(r.score * n_valid).to(torch.int32),
                     delta=torch.zeros_like(r.score),
                     mean_residual=1.0 - r.score)


def process_frame_planes(state: SlamState, scan_x, scan_y, hit, gyro, cmd,
                         cfg, incremental_map: bool = True, field=None,
                         refresh_map: bool = True,
                         shift_maps: bool = True,
                         target_planes=None, pf_target=None,
                         generator: torch.Generator | None = None
                         ) -> SlamState:
    """Sensor frame -> updated state. scan_x / scan_y / hit: (B, N) in the
    robot frame; gyro: (B,) raw yaw rate; cmd: (B, 3) body velocity command.

    incremental_map: fold the registered scene into state.map_grid (False:
    the robots keep no map of their own, as in config 5's fleet or graph
    mode; then the "points" and "fused" targets are re-classified around
    the prediction, and the grid matcher, or a particle matcher without
    pf_target, registers with "points" against state.map_cloud, as
    slam_tpu does). field: the grid matcher's NearestField, which the
    rollout builds once per macro; None builds it from state.map_grid.
    target_planes: optional (mx, my, mga, mvalid) registration target that
    the rollout refreshes once per macro; None registers against
    state.map_cloud. pf_target: a PointMapGrid (batch 1 when the fleet
    shares it) that the particle matcher scores instead of state.map_grid;
    `generator` gives its random draws. refresh_map re-exports map_cloud
    after the update; shift_maps re-centres both rolling grids on the
    fused pose."""
    matcher = cfg.icp.matcher
    if matcher not in MATCHERS:
        raise ValueError(f"unknown icp.matcher {matcher!r} (have "
                         f"{MATCHERS})")
    if not incremental_map and (matcher == "grid" or (
            matcher == "particle" and pf_target is None)):
        matcher = "points"
    dt = cfg.sim.dt

    # non-finite points are misses, and their coordinates are zeroed
    hit = hit & torch.isfinite(scan_x) & torch.isfinite(scan_y)
    if cfg.cloud.min_scan_points > 0:
        hit = hit & (hit.sum(-1, keepdim=True) >= cfg.cloud.min_scan_points)
    scan_x = torch.where(hit, scan_x, 0.0)
    scan_y = torch.where(hit, scan_y, 0.0)

    ekf = ekf_mod.motion_update(state.ekf, cmd, dt, cfg.ekf)
    ekf = ekf_mod.yaw_rate_update(ekf, gyro, cfg.ekf)
    pred = ekf_mod.pose_xyyaw(ekf)

    # robots whose grids are split by rows are stepped alike on every rank
    # of their sp group: the scene's sums must not depend on atomic order
    sx, sy, sga, skeep = build_scene_planes(
        scan_x, scan_y, hit, cfg,
        deterministic=state.local_map.rows is not None)
    scene = planes_to_cloud(sx, sy, sga, skeep)
    if matcher == "grid":
        if field is None:
            field = nearest_point_field(state.map_grid,
                                        cfg.icp.voxel_leaf_obs[0],
                                        cfg.icp.ga_threshold)
        icp = icp_fit_grid(scene.xyz[..., :2], skeep, sga, field, pred,
                           cfg.icp)
    elif matcher == "particle":
        icp = _pf_register(state, scene, skeep, pred, cfg, pf_target,
                           generator)
    elif matcher == "fused":
        tp = target_planes
        if not incremental_map:
            mc = state.map_cloud
            mpx, mpy = mc.xyz[..., 0], mc.xyz[..., 1]
            mga = classify_ga_planes(mpx, mpy, mc.valid, pred[:, :2],
                                     cfg.icp.ga_num_bins,
                                     cfg.icp.ga_resolution,
                                     cfg.icp.ga_threshold)
            tp = (mpx, mpy, mga, mc.valid)
        icp = fused_register(sx, sy, skeep, sga, tp, state.map_cloud, pred,
                             cfg.icp)
    else:
        icp = register_scan(scene, state.map_cloud, pred, cfg,
                            reclassify=not incremental_map)

    metrics.emit("slam_step", icp_ok=icp.ok, num_corr=icp.num_corr,
                 mean_residual=icp.mean_residual)
    ring = metrics.ring_write(state.metrics_ring, site="slam_step",
                              step=state.step, icp_ok=icp.ok,
                              num_corr=icp.num_corr,
                              mean_residual=icp.mean_residual,
                              scene_points=skeep.sum(-1))
    ekf = ekf_mod.slam_update(ekf, icp.pose, cfg.ekf, has_meas=icp.ok)
    fused = ekf_mod.pose_xyyaw(ekf)

    mg, map_cloud = state.map_grid, state.map_cloud
    if incremental_map:
        res = cfg.icp.voxel_leaf_obs[0]
        map_pose = torch.where(icp.ok[:, None], icp.pose, pred)
        qx, qy = se2_apply_xy(map_pose, sx, sy)
        if shift_maps:
            mg = shift_point_map(mg, fused[:, :2], res)
        mg = update_point_map_xy(mg, qx, qy, None, skeep, res)
        if refresh_map:
            map_cloud = export_points(mg, map_cloud.capacity,
                                      ga_threshold=cfg.icp.ga_threshold)

    grid = shift_origin(state.local_map, fused[:, :2], cfg.mls) \
        if shift_maps else state.local_map
    yaw_only = torch.stack([fused[:, 0] - grid.center[:, 0],
                            fused[:, 1] - grid.center[:, 1], fused[:, 2]], -1)
    lx, ly = se2_apply_xy(yaw_only, sx, sy)
    grid = add_to_occupancy_xy(grid, lx, ly, skeep, cfg.mls)

    z = torch.zeros_like(fused[:, :1])
    return state.replace(
        ekf=ekf,
        pose=torch.cat([fused, z], -1),
        scan_reg_pose=torch.cat([icp.pose, z], -1),
        scan_reg_ok=icp.ok,
        local_map=grid,
        prev_scene=scene,
        map_cloud=map_cloud,
        map_grid=mg,
        step=state.step + 1,
        metrics_ring=ring,
    )


def process_frame(state: SlamState, scan_xyz, hit, gyro, cmd, cfg,
                  incremental_map: bool = True, field=None) -> SlamState:
    """process_frame_planes on (B, N, 3) robot-frame scan points."""
    return process_frame_planes(state, scan_xyz[..., 0], scan_xyz[..., 1],
                                hit, gyro, cmd, cfg,
                                incremental_map=incremental_map, field=field)


def slam_step_io(state: SlamState, scan_xyz, hit, gyro, cmd, cfg,
                 field=None) -> SlamState:
    """A tick driven by external sensor frames (replay, live transport or
    oracle comparison): (B, N, 3) scan points, (B,) raw gyro z, (B, 3)
    commanded body velocity; `field` as process_frame_planes takes it."""
    return process_frame(state, scan_xyz, hit, gyro, cmd, cfg, field=field)


def slam_step(state: SlamState, world: world2d.World2D, cfg,
              generator: torch.Generator, incremental_map: bool = True,
              field=None, refresh_map: bool = True, shift_maps: bool = True,
              target_planes=None, pf_target=None) -> SlamState:
    """One simulated tick: drive, sense (range and gyro noise drawn from
    `generator`), then process the frame (the particle matcher draws from
    `generator` too)."""
    dt = cfg.sim.dt
    cmd = ekf_mod.clamp_cmd(world2d.drive_cmd(state.step, dt), cfg.ekf)
    true2 = world2d.unicycle_step(state.true_pose[:, :3], cmd, dt)
    ranges, hit = world2d.raycast(world, true2, cfg.sim, generator=generator)
    scan_x, scan_y, hit = world2d.scan_to_planes(ranges, hit)
    gyro = cmd[:, 2] + cfg.sim.gyro_bias + cfg.sim.gyro_noise * torch.randn(
        cmd.shape[0], generator=generator, device=cmd.device)
    state = process_frame_planes(state, scan_x, scan_y, hit, gyro, cmd, cfg,
                                 incremental_map=incremental_map,
                                 field=field, refresh_map=refresh_map,
                                 shift_maps=shift_maps,
                                 target_planes=target_planes,
                                 pf_target=pf_target, generator=generator)
    return state.replace(true_pose=torch.cat(
        [true2, torch.zeros_like(true2[:, :1])], -1))


def rollout(state: SlamState, world: world2d.World2D, cfg, num_steps: int,
            generator: torch.Generator, field_every: int = 4):
    """Run num_steps ticks, rounded up to whole macros of field_every ticks.

    Each macro exports the registration target from the point map once
    (the grid matcher builds its nearest-centroid field from the grid
    instead, before the shift, and the particle matcher scores the grid
    itself: neither exports) and re-centres both rolling grids once (the
    robot moves about a cell per macro); its ticks then register against
    that target and skip the shifts. Returns (final_state, (est, true)),
    trajectories (B, num_steps, 3). Under metrics.nan_debug the state is
    checked finite after every tick."""
    num_macro = -(-num_steps // field_every)
    est, true = [], []
    s = state
    for _ in range(num_macro):
        planes = field = None
        if cfg.icp.matcher == "grid":
            field = nearest_point_field(s.map_grid, cfg.icp.voxel_leaf_obs[0],
                                        cfg.icp.ga_threshold)
        elif cfg.icp.matcher != "particle":
            ex, ey, ez, ega, evalid = export_point_planes(
                s.map_grid, s.map_cloud.capacity,
                ga_threshold=cfg.icp.ga_threshold)
            planes = (ex, ey, ega, evalid)
            s = s.replace(map_cloud=planes_to_cloud(ex, ey, ega, evalid, ez))
        s = s.replace(
            map_grid=shift_point_map(s.map_grid, s.pose[:, :2]),
            local_map=shift_origin(s.local_map, s.pose[:, :2], cfg.mls))
        for _ in range(field_every):
            s = slam_step(s, world, cfg, generator, field=field,
                          refresh_map=False, shift_maps=False,
                          target_planes=planes)
            metrics.check_finite(len(est), state=s)
            est.append(s.pose[:, :3])
            true.append(s.true_pose[:, :3])
    return s, (torch.stack(est, 1)[:, :num_steps],
               torch.stack(true, 1)[:, :num_steps])


def graph_update(state: SlamState, cfg) -> SlamState:
    """A graph tick, the pose offset discarded: 2D maps carry no z for it
    to shift."""
    return graph_update_delta(state, cfg)[0]


def graph_update_delta(state: SlamState, cfg):
    """A graph tick for every robot: gate and insert a keyframe (the last
    scene at the fused pose, with the last tick's ground sample appended
    where the state carries one, for 6-DoF keyframes; the measured
    attitude for their tilt) with its edges, optimise the graphs that
    gained a keyframe and hold an edge (graph.engine "se2z":
    pose_graph.optimize; "se3": pose_graph3d.optimize_planar, or
    optimize_native over edge_registration "3d"), and regenerate the
    scan-to-map target of the robots that gained one. Returns (state,
    delta): delta (B, 4) is the newest node's pose change across the
    optimisation, zero where none ran. The EKF is not shifted by it.

    Every robot runs every stage and torch.where keeps what its own gates
    select, so the tick never waits for the card. The target is
    regenerated by graph.map_regen's engine: "voxel" (a voxel merge of
    every keyframe), "mls" (a global MLS rebuild's obstacle export) or
    "grid". Not ported to grids split by rows: raises
    NotImplementedError there."""
    refuse(state.local_map, "graph mode's map regeneration",
           "graph regeneration")
    gcfg = cfg.graph
    kf_cloud = state.prev_scene
    if state.prev_ground is not None:
        # obstacles first, so that the keyframe's compaction never drops
        # them
        kf_cloud = PointCloud(
            xyz=torch.cat([kf_cloud.xyz, state.prev_ground.xyz], 1),
            valid=torch.cat([kf_cloud.valid, state.prev_ground.valid], 1),
            flags=torch.cat([kf_cloud.flags, state.prev_ground.flags], 1))
    graph, added = pg.add_keyframe(state.graph, state.pose, kf_cloud,
                                   cfg.icp, gcfg,
                                   min_points=gcfg.min_keyframe_points,
                                   attitude=state.attitude)
    opt = added & (graph.num_edges > 0)
    if gcfg.engine == "se3" and gcfg.edge_registration == "3d":
        optimized, delta = pg3.optimize_native(graph, gcfg)
    elif gcfg.engine == "se3":
        optimized, delta = pg3.optimize_planar(graph, gcfg)
    else:
        optimized, delta = pg.optimize(graph, gcfg)
    graph = graph.replace(node_pose=torch.where(
        opt[:, None, None], optimized.node_pose, graph.node_pose))
    if graph.node_rp is not None:
        graph = graph.replace(node_rp=torch.where(
            opt[:, None, None], optimized.node_rp, graph.node_rp))
    delta = torch.where(opt[:, None], delta, 0.0)
    capacity = state.map_cloud.capacity
    if gcfg.map_regen == "grid":
        # cfg.cloud.export_recall is passed as slam_tpu passes it; the
        # port's export is always the exact top-k, which is what slam_tpu's
        # approx_max_k gives off the TPU, so the knob has no effect here
        regen = pg.regenerate_map_grid(
            graph, capacity, resolution=cfg.icp.voxel_leaf_obs[0],
            grid_bins=gcfg.regen_grid_bins,
            ga_threshold=cfg.icp.ga_threshold,
            recall=cfg.cloud.export_recall)
    elif gcfg.map_regen == "mls":
        # the 2D path has no ground class: the obstacle export is the
        # whole target
        regen = pg.regenerate_map_mls(graph, cfg.mls, capacity)[0]
    else:
        regen = pg.regenerate_map(graph, capacity, cfg.icp.voxel_leaf_obs)
    map_cloud = select_cloud(added, regen, state.map_cloud)
    full = graph.num_nodes >= gcfg.max_nodes
    metrics.emit("graph_update", added=added, num_nodes=graph.num_nodes,
                 num_edges=graph.num_edges, graph_full=full)
    ring = metrics.ring_write(state.metrics_ring, site="graph_update",
                              step=state.step, graph_nodes=graph.num_nodes,
                              graph_edges=graph.num_edges)
    return state.replace(graph=graph, map_cloud=map_cloud, graph_full=full,
                         metrics_ring=ring), delta


def rollout_with_graph(state: SlamState, world: world2d.World2D, cfg,
                       num_macro: int, generator: torch.Generator,
                       graph_every: int = 8):
    """BASELINE config 4: num_macro macros, each one re-centring of the
    occupancy grid, graph_every ticks registering against the graph's
    regenerated target (incremental_map=False: the robots keep no map
    grid), then a graph tick. Returns (final_state, (est, true)),
    trajectories (B, num_macro * graph_every, 3). Under metrics.nan_debug
    the state is checked finite after every tick and graph tick. Not
    ported to grids split by rows: raises NotImplementedError there."""
    refuse(state.local_map, "graph mode's map regeneration",
           "graph regeneration")
    est, true = [], []
    s = state
    for _ in range(num_macro):
        s = s.replace(local_map=shift_origin(s.local_map, s.pose[:, :2],
                                             cfg.mls))
        for _ in range(graph_every):
            s = slam_step(s, world, cfg, generator, incremental_map=False,
                          shift_maps=False)
            metrics.check_finite(len(est), state=s)
            est.append(s.pose[:, :3])
            true.append(s.true_pose[:, :3])
        s = graph_update(s, cfg)
        metrics.check_finite(len(est) - 1, state=s)
    return s, (torch.stack(est, 1), torch.stack(true, 1))


def ate(est: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (RMSE of xy) over the time axis:
    (..., T, >=2) -> (...)."""
    d = est[..., :2] - true[..., :2]
    return torch.sqrt((d * d).sum(-1).mean(-1))


def ate_aligned(est: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """ATE after aligning each trajectory to the truth by the SE(2)
    Horn / Umeyama closed form (no scale): (..., T, >=2) -> (...). It
    removes the static rigid offset that an error frozen into the early
    map gives the whole trajectory, which raw ATE charges at every step."""
    a = est[..., :2]
    b = true[..., :2]
    ma = a.mean(-2, keepdim=True)
    mb = b.mean(-2, keepdim=True)
    H = (a - ma).mT @ (b - mb)                              # (..., 2, 2)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.mT
    d = torch.sign(torch.linalg.det(V @ U.mT))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), d], -1))
    R = V @ D @ U.mT
    e = (a - ma) @ R.mT + mb - b
    return torch.sqrt((e * e).sum(-1).mean(-1))
