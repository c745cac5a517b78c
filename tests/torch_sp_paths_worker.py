"""One rank of tests/test_torch_sp_paths.py: a gloo process on the CPU.

    python -m tests.torch_sp_paths_worker RANK WORLD WORKDIR

Joins the group through a file store in WORKDIR, reads the inputs the test
wrote there (inputs.pt), runs the four sp paths beyond the 2D ticks on the
(dp, sp) layouts 1 x 4 and 2 x 2, each robot's grids split by rows, and
writes its results to WORKDIR/rank{RANK}.pt. Imports torch and the port
only, never jax.

The configurations are the port's counterparts of slam_tpu's
dryrun_multichip paths (__graft_entry__.py), sensor noise off:
- "ref3d": the 3D reference-scale engines at tiny shapes (grid scene
  builder, "grid" matcher, grid height): one slam_step_3d without shifts,
  a 2-macro rollout_3d, and two 4-tick macros of rollout_3d_with_graph
  (engine "se2z"); 64 azimuths (dryrun's 16 leave the map too few cells
  for a fit to pass its gates);
- "grid2d": the 2D scale engines (grid scene builder, "grid" matcher), a
  2-macro rollout;
- "graph": graph mode, two macros of 4 ticks and a graph tick, a keyframe
  every 0.4 m (so that the second graph tick adds an edge) and the "grid"
  regeneration;
- "mls": a tick, the scene folded into the MLS banks, robot 0 flagged
  lost and relocalized.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from slam_tpu_torch.config import sim2d_config, sim3d_config
from slam_tpu_torch.geometry import se2_apply
from slam_tpu_torch.mapping.mls import add_to_mls
from slam_tpu_torch.ops import grid_icp
from slam_tpu_torch.parallel import mesh as tmesh
from slam_tpu_torch.parallel import multihost
from slam_tpu_torch.pipeline import slam2d, slam3d
from slam_tpu_torch.pipeline.relocalize import fleet_relocalize_if_lost

LAYOUTS = (4, 2)        # sp: dp1 x sp4 and dp2 x sp2 on four ranks
GRAPH_EVERY = 4
GRAPH_MACROS = 2


def _rep(c, **kw):
    return dataclasses.replace(c, **kw)


def _noise_free(c):
    return _rep(c, sim=_rep(c.sim, range_noise=0.0, gyro_noise=0.0))


def tiny2d():
    """dryrun_multichip's _tiny_config, noise-free, with sim2d_config's 360
    beams (into 384 scan and 128 scene slots) and its grids widened to 64
    cells: at 64 beams and 32 cells (of 0.5 m in the scene's GA grid and
    the point map, 1 m in the MLS banks) the tiny world's scans land
    outside the grids, and the scenes, maps and graph edges stay empty."""
    c = sim2d_config()
    return _noise_free(_rep(
        c,
        icp=_rep(c.icp, max_points=64, max_iterations=3, ga_num_bins=64,
                 crop_dist=15.0),
        cloud=_rep(c.cloud, scan_capacity=384, scene_capacity=128,
                   ground_capacity=8, map_capacity=256),
        mls=_rep(c.mls, size_x=64, size_y=64, resolution=1.0,
                 max_range=30.0, update_dist=16),
        sim=_rep(c.sim, num_beams=360, num_obstacles=16)))


def configs() -> dict:
    """The four paths' configurations (dryrun_multichip's, noise-free)."""
    c = tiny2d()
    c3 = sim3d_config()
    ref3d = _noise_free(_rep(
        c3,
        sim=_rep(c3.sim, num_rings=8, num_azimuth=64, beam_max_range=40.0),
        ground=_rep(c3.ground, num_sectors=4, num_range_bins=8,
                    signal_capacity=8, max_insac_sweeps=3),
        icp=_rep(c3.icp, matcher="grid", max_points=64, max_iterations=3,
                 ga_num_bins=32, scan_grid_bins=32),
        height=_rep(c3.height, source="grid"),
        cloud=_rep(c3.cloud, scan_capacity=128, scene_capacity=64,
                   ground_capacity=64, map_capacity=128,
                   scene_builder="grid"),
        mls=_rep(c3.mls, size_x=32, size_y=32, resolution=1.0,
                 max_range=30.0, update_dist=16)))
    graph = _rep(c.graph, max_nodes=8, max_edges=16, keyframe_points=64,
                 knn_dist_thresh=0.4)
    return dict(
        grid2d=_rep(c, icp=_rep(c.icp, matcher="grid", scan_grid_bins=64),
                    cloud=_rep(c.cloud, scene_builder="grid")),
        graph=_rep(c, graph=_rep(graph, map_regen="grid",
                                 regen_grid_bins=64)),
        mls=_rep(c, global_match=_rep(c.global_match, grid_size=32,
                                      num_rotations=4)),
        ref3d=ref3d, ref3d_graph=_rep(ref3d, graph=graph))


def replicated(state) -> dict:
    """The per-robot state outside the grids, which every rank of an sp
    group must hold bit for bit alike."""
    out = dict(pose=state.pose, mu=state.ekf.mu, sigma=state.ekf.sigma,
               reg=state.scan_reg_pose, ok=state.scan_reg_ok,
               map_xyz=state.map_cloud.xyz, map_valid=state.map_cloud.valid,
               map_flags=state.map_cloud.flags,
               scene_xyz=state.prev_scene.xyz)
    if state.graph is not None:
        out.update(nodes=state.graph.node_pose, edges=state.graph.edge_rel,
                   n_nodes=state.graph.num_nodes,
                   n_edges=state.graph.num_edges)
    return out


def my_robots(mesh, x):
    """This rank's robots (its dp shard) of a batched tensor tree."""
    i = mesh.coords()[0]
    n = mesh.shape["dp"]
    return tmesh.tree_map(
        lambda t: t[i * t.shape[0] // n:(i + 1) * t.shape[0] // n], x)


def slab_shape(grids) -> tuple:
    """The shape of a grid container's first (B, H, W, ...) leaf (a
    GroundMap's grid's)."""
    g = getattr(grids, "grid", grids)
    return next(tuple(t.shape) for t in (getattr(g, f.name) for f in
                                         dataclasses.fields(g))
                if isinstance(t, torch.Tensor) and t.dim() >= 3)


def result(mesh, state, est, true, grids, field=None) -> dict:
    """Trajectories gathered over dp, grids gathered whole (for the test's
    checks), this rank's slab shapes and field rows, and its replicated
    state."""
    out = dict(est=tmesh.gather_fleet(mesh, est),
               true=tmesh.gather_fleet(mesh, true),
               grids={k: tmesh.gather_grids(mesh, g) for k, g in
                      grids.items()},
               shapes={k: slab_shape(g) for k, g in grids.items()},
               coords=mesh.coords(), replicated=replicated(state))
    if field is not None:
        out["field"] = (field.px, field.py, field.valid, field.n_class)
    return out


def ref3d(inp, mesh, cfgs):
    """The 3D reference-scale engines: a step without shifts, a 2-macro
    rollout_3d, and one macro of rollout_3d_with_graph."""
    cfg, world = cfgs["ref3d"], inp["world3"]
    st = tmesh.shard_fleet(mesh, inp["states3"], device="cpu")
    gm = tmesh.shard_grids(mesh, inp["gm3"], device="cpu")
    s1, g1 = slam3d.slam_step_3d(st, world, gm, cfg, shift_maps=False)
    step = result(mesh, s1, s1.pose[:, None], s1.true_pose[:, None],
                  dict(local_map=s1.local_map, map_grid=s1.map_grid,
                       ground=g1))
    fin, gfin, (est, true, _) = slam3d.rollout_3d(st, world, gm, cfg, 8)
    roll = result(mesh, fin, est, true,
                  dict(local_map=fin.local_map, map_grid=fin.map_grid,
                       ground=gfin),
                  grid_icp.nearest_point_field(
                      fin.map_grid, cfg.icp.voxel_leaf_obs[0],
                      cfg.icp.ga_threshold))
    gs = tmesh.shard_fleet(mesh, inp["states3g"], device="cpu")
    gfin, ggm, (est, true) = slam3d.rollout_3d_with_graph(
        gs, world, gm, cfgs["ref3d_graph"], GRAPH_MACROS,
        graph_every=GRAPH_EVERY)
    graph = result(mesh, gfin, est, true,
                   dict(local_map=gfin.local_map, ground=ggm))
    return dict(step=step, rollout=roll, graph=graph)


def grid2d(inp, mesh, cfgs):
    """The 2D scale engines: a 2-macro rollout with the "grid" matcher."""
    cfg = cfgs["grid2d"]
    st = tmesh.shard_fleet(mesh, inp["states_grid"], device="cpu")
    fin, (est, true) = slam2d.rollout(st, inp["world"], cfg, 8,
                                      torch.Generator())
    return result(mesh, fin, est, true,
                  dict(local_map=fin.local_map, map_grid=fin.map_grid),
                  grid_icp.nearest_point_field(
                      fin.map_grid, cfg.icp.voxel_leaf_obs[0],
                      cfg.icp.ga_threshold))


def graph(inp, mesh, cfgs):
    """Graph mode: GRAPH_MACROS macros of GRAPH_EVERY ticks and a graph
    tick."""
    st = tmesh.shard_fleet(mesh, inp["states_graph"], device="cpu")
    fin, (est, true) = slam2d.rollout_with_graph(
        st, inp["world"], cfgs["graph"], GRAPH_MACROS, torch.Generator(),
        GRAPH_EVERY)
    return result(mesh, fin, est, true, dict(local_map=fin.local_map))


def mls_reloc(state, grids, world, cfg, lost):
    """dryrun_multichip's MLS + relocalization step: a tick, the scene
    folded into the MLS banks at the fused pose, the lost robots
    relocalized. Returns (state, grids)."""
    s = slam2d.slam_step(state, world, cfg, torch.Generator())
    scene = s.prev_scene
    xy = se2_apply(s.pose[:, :3], scene.xyz[..., :2])
    g = add_to_mls(grids, scene.replace(
        xyz=torch.cat([xy, scene.xyz[..., 2:]], -1)), cfg.mls)
    return fleet_relocalize_if_lost(s, cfg, lost=lost), g


def mls(inp, mesh, cfgs):
    st = tmesh.shard_fleet(mesh, inp["states_mls"], device="cpu")
    grids = tmesh.shard_grids(mesh, inp["mls_grids"], device="cpu")
    lost = my_robots(mesh, torch.arange(inp["mls_grids"].center.shape[0])
                     == 0)
    s, g = mls_reloc(st, grids, inp["world"], cfgs["mls"], lost)
    return result(mesh, s, s.pose[:, None], s.true_pose[:, None],
                  dict(local_map=s.local_map, map_grid=s.map_grid, mls=g))


def main():
    me, n, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    multihost.init_distributed("file://" + os.path.join(workdir, "store"),
                               n, me, backend="gloo")
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    cfgs = configs()
    out = {}
    for sp in LAYOUTS:
        mesh = multihost.make_fleet_mesh(sp)
        out[sp] = dict(mesh=mesh.ranks.tolist(), ref3d=ref3d(inp, mesh, cfgs),
                       grid2d=grid2d(inp, mesh, cfgs),
                       graph=graph(inp, mesh, cfgs), mls=mls(inp, mesh, cfgs))
    torch.save(out, os.path.join(workdir, f"rank{me}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
