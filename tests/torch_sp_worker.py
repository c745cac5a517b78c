"""One rank of tests/test_torch_sp.py: a gloo process on the CPU.

    python -m tests.torch_sp_worker RANK WORLD WORKDIR

Joins the group through a file store in WORKDIR, reads the inputs the test
wrote there (inputs.pt), runs every case on the (dp, sp) layouts 1 x 4 and
2 x 2 and writes its results to WORKDIR/rank{RANK}.pt. Imports torch and
the port only, never jax.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from slam_tpu_torch.mapping.mls import add_to_mls
from slam_tpu_torch.parallel import mesh as tmesh
from slam_tpu_torch.parallel import multihost, shared_map
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.types import PointCloud
from tests.torch_dist_worker import noise_free

LAYOUTS = (4, 2)        # sp: dp1 x sp4 and dp2 x sp2 on four ranks


def replicated(state) -> dict:
    """The per-robot state outside the grids, which every rank of an sp
    group must hold bit for bit alike."""
    return dict(pose=state.pose, mu=state.ekf.mu, sigma=state.ekf.sigma,
                reg=state.scan_reg_pose, ok=state.scan_reg_ok,
                map_xyz=state.map_cloud.xyz, map_valid=state.map_cloud.valid,
                map_flags=state.map_cloud.flags,
                scene_xyz=state.prev_scene.xyz)


def slab_shapes(grid) -> dict:
    return {f.name: tuple(getattr(grid, f.name).shape)
            for f in dataclasses.fields(grid)
            if isinstance(getattr(grid, f.name), torch.Tensor)}


def my_robots(mesh, x):
    """This rank's robots (its dp shard) of a batched tensor tree."""
    i = mesh.coords()[0]
    n = mesh.shape["dp"]
    return tmesh.tree_map(
        lambda t: t[i * t.shape[0] // n:(i + 1) * t.shape[0] // n], x)


def config1(inp, mesh, matcher):
    """slam2d.rollout, 8 ticks, on this rank's robots and rows."""
    states = tmesh.shard_fleet(mesh, inp["fleet_states"], device="cpu")
    fin, (est, true) = slam2d.rollout(states, inp["world"],
                                      noise_free(matcher), 8,
                                      torch.Generator().manual_seed(0))
    return dict(est=tmesh.gather_fleet(mesh, est),
                true=tmesh.gather_fleet(mesh, true),
                local_map=tmesh.gather_grids(mesh, fin.local_map),
                map_grid=tmesh.gather_grids(mesh, fin.map_grid),
                shapes=(slab_shapes(fin.local_map),
                        slab_shapes(fin.map_grid)),
                rows=(fin.local_map.rows.j, fin.map_grid.rows.H),
                replicated=replicated(fin))


def mls(inp, mesh):
    """add_to_mls on this rank's robots' slabs of the MLS banks."""
    grids = tmesh.shard_grids(mesh, inp["mls_grids"], device="cpu")
    xyz = my_robots(mesh, inp["mls_xyz"])
    out = add_to_mls(grids, PointCloud(
        xyz=xyz, valid=torch.ones(xyz.shape[:2], dtype=torch.bool),
        flags=torch.zeros(xyz.shape[:2], dtype=torch.int32)), inp["mls_cfg"])
    return dict(grid=tmesh.gather_grids(mesh, out), shape=slab_shapes(out))


def merger(inp, mesh):
    """make_shared_map_merger on this rank's dp shard of whole grids,
    aligned and with dp shard 1's grids moved."""
    merge = shared_map.make_shared_map_merger(mesh)
    mine = my_robots(mesh, inp["merge_grids"])
    moved = mine.replace(center=mine.center + 0.5) \
        if mesh.coords()[0] == 1 else mine
    return dict(aligned=merge(mine), misaligned=merge(moved))


def shared(inp, mesh):
    """Config 5, 2 macros of fleet_rollout_shared, the robots' local_map
    split by rows and the shared grid whole on every rank."""
    states = tmesh.shard_fleet(mesh, inp["pf_states"], device="cpu")
    fin, grid, (est, true) = shared_map.fleet_rollout_shared(
        states, inp["pf_shared"], inp["world"],
        noise_free("particle", num_particles=1, score_stride=4), 2,
        generator=torch.Generator(), mesh=mesh)
    return dict(est=tmesh.gather_fleet(mesh, est),
                true=tmesh.gather_fleet(mesh, true), shared=grid,
                ok=tmesh.gather_fleet(mesh, fin.scan_reg_ok),
                local_map=tmesh.gather_grids(mesh, fin.local_map),
                replicated=replicated(fin))


def main():
    me, n, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    multihost.init_distributed("file://" + os.path.join(workdir, "store"),
                               n, me, backend="gloo")
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    for sp in LAYOUTS:
        mesh = multihost.make_fleet_mesh(sp)
        out[sp] = dict(mesh=mesh.ranks.tolist(), coords=mesh.coords(),
                       points=config1(inp, mesh, "points"),
                       fused=config1(inp, mesh, "fused"),
                       mls=mls(inp, mesh), shared=shared(inp, mesh))
        if mesh.shape["dp"] > 1:
            out[sp]["merger"] = merger(inp, mesh)
    torch.save(out, os.path.join(workdir, f"rank{me}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
