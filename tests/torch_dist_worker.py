"""One rank of tests/test_torch_distributed.py: a gloo process on the CPU.

    python -m tests.torch_dist_worker RANK WORLD WORKDIR

Joins the group through a file store in WORKDIR, reads the inputs the
test wrote there (inputs.pt: the port's states, world and grids, carried
across from slam_tpu by the test), runs each case and writes its results
to WORKDIR/rank{RANK}.pt. Imports torch and the port only, never jax.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from slam_tpu_torch import mesh_scaling
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.parallel import mesh as tmesh
from slam_tpu_torch.parallel import multihost, shared_map
from slam_tpu_torch.pipeline import slam2d


def noise_free(matcher, **pf):
    c = sim2d_config()
    return dataclasses.replace(
        c, icp=dataclasses.replace(c.icp, matcher=matcher),
        pf=dataclasses.replace(c.pf, **pf),
        sim=dataclasses.replace(c.sim, range_noise=0.0, gyro_noise=0.0))


def fleet(inp, mesh):
    """Config 1 over dp: this rank's robots of the whole fleet, 8 ticks,
    the trajectories gathered."""
    states = tmesh.shard_fleet(mesh, inp["fleet_states"], device="cpu")
    _, (est, true) = slam2d.rollout(states, inp["world"],
                                    noise_free("points"), 8,
                                    torch.Generator().manual_seed(0))
    return dict(local=states.pose.shape[0], est=tmesh.gather_fleet(mesh, est),
                true=tmesh.gather_fleet(mesh, true))


def merger(inp, mesh, me):
    """make_shared_map_merger on this rank's 4 of 8 grids, aligned and with
    rank 1's grids moved."""
    merge = shared_map.make_shared_map_merger(mesh)
    grids = inp["grids"]
    mine = grids.replace(**{n: getattr(grids, n)[4 * me:4 * me + 4]
                            for n in (*shared_map.CHANNELS, "center")})
    moved = mine.replace(center=mine.center + 0.5) if me == 1 else mine
    return dict(aligned=merge(mine), misaligned=merge(moved))


def shared(inp, mesh):
    """Config 5 over dp: 2 macros of fleet_rollout_shared, one robot a
    rank, the shared grid merged by the all-reduce."""
    states = tmesh.shard_fleet(mesh, inp["pf_states"], device="cpu")
    fin, grid, (est, true) = shared_map.fleet_rollout_shared(
        states, inp["pf_shared"], inp["world"],
        noise_free("particle", num_particles=1, score_stride=4), 2,
        generator=torch.Generator(), mesh=mesh)
    return dict(est=tmesh.gather_fleet(mesh, est),
                true=tmesh.gather_fleet(mesh, true), shared=grid,
                ok=tmesh.gather_fleet(mesh, fin.scan_reg_ok))


def scaling():
    """mesh_scaling's rows at B = 2 over the two ranks: sp = 1 (one robot a
    rank) and sp = 2 (both robots on both ranks, each rank half of every
    grid's rows)."""
    rows = mesh_scaling.main(["--batches", "2", "--steps", "1",
                              "--device", "cpu"])
    sp_rows = mesh_scaling.main(["--sp", "2", "--batches", "2", "--steps",
                                 "1", "--device", "cpu"])
    return dict(rows=rows, sp_rows=sp_rows)


def main():
    me, n, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    store = "file://" + os.path.join(workdir, "store")
    multihost.init_distributed(store, n, me, backend="gloo")
    multihost.init_distributed(store, n, me, backend="gloo")  # a no-op
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = multihost.make_fleet_mesh()
    out = dict(world=dist.get_world_size(), rank=multihost.rank(),
               mesh=mesh.shape, local_batch=multihost.host_local_batch(8),
               fleet=fleet(inp, mesh), merger=merger(inp, mesh, me),
               shared=shared(inp, mesh), scaling=scaling())
    torch.save(out, os.path.join(workdir, f"rank{me}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
