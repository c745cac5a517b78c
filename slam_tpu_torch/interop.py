"""Carry state across from slam_tpu and back.

slam_tpu's SlamState, GroundMap, World2D and World3D are pytrees; after
`jax.tree.map(np.asarray, ...)` their leaves are numpy arrays, stacked over
robots (leading dim B) for a fleet, the 6-DoF graph's fields included. `state_from_numpy`,
`ground_map_from_numpy`, `world_from_numpy` and `world3d_from_numpy` read
such objects by attribute (no jax import), so both packages can start from
the identical state; `mls_grid_from_numpy` reads an MlsGrid stacked over
robots; `point_map_from_numpy` reads one unbatched grid (config 5's shared
map) as a batch-1 PointMapGrid, or grids stacked over robots;
`codebook_from_numpy` places a fiducial codebook (K, bits) on a device,
and `sample_map_from_numpy` reads a SampleMap (one map as batch 1, or
maps stacked over robots); `state_to_numpy` turns a port state, ground map, pose graph or MLS grid
back into a nested dict of numpy arrays with the same field names (a
metrics ring stays a (buf, count) pair); `se3_graph_from_numpy` reads a 6-DoF Se3Graph stacked over robots. The JAX
state's random key is dropped: the port draws from an explicit
torch.Generator. Tensors land on the card unless `device` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.graph.pose_graph3d import Se3Graph
from slam_tpu_torch.mapping.sample_map import SampleMap
from slam_tpu_torch.mapping.point_map import PointMapGrid
from slam_tpu_torch.sim.world2d import World2D
from slam_tpu_torch.sim.world3d import World3D
from slam_tpu_torch.types import (EkfState, GroundMap, MlsGrid,
                                  OccupancyGrid, PointCloud, PoseGraph,
                                  SlamState)


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _cloud(c, device) -> PointCloud:
    return PointCloud(xyz=_t(c.xyz, device, torch.float32),
                      valid=_t(c.valid, device, torch.bool),
                      flags=_t(c.flags, device, torch.int32))


def _grid(mg, device) -> PointMapGrid:
    return PointMapGrid(
        count=_t(mg.count, device, torch.float32),
        sum_x=_t(mg.sum_x, device, torch.float32),
        sum_y=_t(mg.sum_y, device, torch.float32),
        sum_z=_t(mg.sum_z, device, torch.float32),
        center=_t(mg.center, device, torch.float32),
        resolution=float(mg.resolution))


def graph_from_numpy(g, device=None) -> PoseGraph:
    """Port PoseGraph from a slam_tpu PoseGraph with numpy leaves stacked
    over robots, planar or 6-DoF (node_rp, edge_rel6, edge_info6)."""
    device = default_device(device)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    return PoseGraph(**{k: _t(getattr(g, k), device, dt) for k, dt in (
        ("node_pose", f32), ("node_valid", b8), ("node_stamp", i32),
        ("kf_xyz", f32), ("kf_valid", b8), ("kf_flags", i32),
        ("edge_ij", i32), ("edge_rel", f32), ("edge_info", f32),
        ("edge_valid", b8), ("num_nodes", i32), ("num_edges", i32),
        ("edges_dropped", i32), ("node_rp", f32), ("edge_rel6", f32),
        ("edge_info6", f32)) if getattr(g, k, None) is not None})


def se3_graph_from_numpy(g, device=None) -> Se3Graph:
    """Port Se3Graph (graph/pose_graph3d.py) from a slam_tpu Se3Graph with
    numpy leaves stacked over robots."""
    device = default_device(device)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    return Se3Graph(**{k: _t(getattr(g, k), device, dt) for k, dt in (
        ("node_t", f32), ("node_R", f32), ("node_valid", b8),
        ("edge_ij", i32), ("edge_t", f32), ("edge_R", f32),
        ("edge_info", f32), ("edge_valid", b8))})


def mls_grid_from_numpy(g, device=None) -> MlsGrid:
    """Port MlsGrid from a slam_tpu MlsGrid with numpy leaves stacked over
    robots."""
    device = default_device(device)
    f32 = torch.float32
    return MlsGrid(mean=_t(g.mean, device, f32), var_z=_t(g.var_z, device, f32),
                   num_pts=_t(g.num_pts, device, f32),
                   drivable=_t(g.drivable, device, torch.int8),
                   origin=_t(g.origin, device, torch.int32),
                   center=_t(g.center, device, f32))


def state_from_numpy(st, device=None) -> SlamState:
    """Port state from a slam_tpu SlamState with numpy leaves stacked over
    robots, its pose graph (planar or 6-DoF), the 6-DoF keyframes' ground
    sample and the metrics ring included. A state without a map grid
    (config 5's fleet, 2D graph mode) keeps map_grid None."""
    prev_ground = getattr(st, "prev_ground", None)
    attitude = getattr(st, "attitude", None)
    graph_full = getattr(st, "graph_full", None)
    ring = getattr(st, "metrics_ring", None)
    device = default_device(device)
    occ = st.local_map
    return SlamState(
        ekf=EkfState(mu=_t(st.ekf.mu, device, torch.float32),
                     sigma=_t(st.ekf.sigma, device, torch.float32),
                     gyro_bias=_t(st.ekf.gyro_bias, device, torch.float32)),
        pose=_t(st.pose, device, torch.float32),
        scan_reg_pose=_t(st.scan_reg_pose, device, torch.float32),
        scan_reg_ok=_t(st.scan_reg_ok, device, torch.bool),
        local_map=OccupancyGrid(
            counts=_t(occ.counts, device, torch.float32),
            drivable=_t(occ.drivable, device, torch.int8),
            origin=_t(occ.origin, device, torch.int32),
            center=_t(occ.center, device, torch.float32)),
        prev_scene=_cloud(st.prev_scene, device),
        map_cloud=_cloud(st.map_cloud, device),
        map_grid=None if st.map_grid is None else _grid(st.map_grid, device),
        step=_t(st.step, device, torch.int32),
        true_pose=_t(st.true_pose, device, torch.float32),
        attitude=(None if attitude is None
                  else _t(attitude, device, torch.float32)),
        graph=None if st.graph is None else graph_from_numpy(st.graph,
                                                             device),
        graph_full=(None if graph_full is None
                    else _t(graph_full, device, torch.bool)),
        metrics_ring=(None if ring is None else
                      (_t(ring[0], device, torch.float32),
                       _t(ring[1], device, torch.int32))),
        prev_ground=(None if prev_ground is None
                     else _cloud(prev_ground, device)),
    )


def ground_map_from_numpy(gm, device=None) -> GroundMap:
    """Port GroundMap from a slam_tpu GroundMap with numpy leaves stacked
    over robots."""
    device = default_device(device)
    return GroundMap(grid=_grid(gm.grid, device), cloud=_cloud(gm.cloud,
                                                              device))


def world_from_numpy(world, device=None) -> World2D:
    """Port world from a slam_tpu World2D with numpy leaves."""
    device = default_device(device)
    return World2D(centers=_t(world.centers, device, torch.float32),
                   radii=_t(world.radii, device, torch.float32),
                   extent=_t(world.extent, device, torch.float32))


def world3d_from_numpy(world, device=None) -> World3D:
    """Port world from a slam_tpu World3D with numpy leaves."""
    device = default_device(device)
    return World3D(centers=_t(world.centers, device, torch.float32),
                   radii=_t(world.radii, device, torch.float32),
                   heights=_t(world.heights, device, torch.float32),
                   terrain=_t(world.terrain, device, torch.float32),
                   extent=_t(world.extent, device, torch.float32))


def point_map_from_numpy(grid, device=None) -> PointMapGrid:
    """A port PointMapGrid from a slam_tpu PointMapGrid with numpy leaves:
    one unbatched grid ((G, G) channels, (2,) centre) as batch 1, or grids
    stacked over robots ((B, G, G), (B, 2)) as they are."""
    device = default_device(device)
    g = _grid(grid, device)
    if g.center.dim() == 2:
        return g
    return g.replace(count=g.count[None], sum_x=g.sum_x[None],
                     sum_y=g.sum_y[None], sum_z=g.sum_z[None],
                     center=g.center[None])


def codebook_from_numpy(codebook, device=None) -> torch.Tensor:
    """A fiducial codebook (K, bits) as a bool tensor."""
    return _t(codebook, default_device(device), torch.bool)


def sample_map_from_numpy(m, device=None) -> SampleMap:
    """Port SampleMap from a slam_tpu SampleMap with numpy leaves: one map
    (H, W) as batch 1, or maps stacked over robots (B, H, W)."""
    prob = _t(m.prob, default_device(device), torch.float32)
    return SampleMap(prob=prob[None] if prob.dim() == 2 else prob)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__dataclass_fields__"):
        return {k: _np(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x


def state_to_numpy(state) -> dict:
    """A port SlamState (or GroundMap, PoseGraph or MlsGrid) as a nested
    dict of numpy arrays, keyed by slam_tpu's field names."""
    return _np(state)
