"""Reference-scale fleet scaling over ranks — counterpart of
tools/mesh_scaling.py.

    torchrun --nproc-per-node N -m slam_tpu_torch.mesh_scaling
        [--batches 16,32,64] [--steps 4] [--sp 1] [--backend nccl|gloo]
        [--device cpu]

Config 2 at ref_scale_config with the "grid" matcher (20,480-ray scans,
384 x 384 maps: bench.py's bench_ref_scale configuration), the fleet split
over the dp axis of make_fleet_mesh. For each batch B every rank builds
its B / N robots (host_local_batch) from a generator seeded from (0,
rank), runs `steps` ticks to warm up, then `steps` timed ticks, and rank
0 prints one line:

  - each rank's peak device memory over the batch
    (torch.cuda.max_memory_allocated): the quantity the dp split must
    shrink, in place of XLA's memory analysis;
  - the robots a rank;
  - the aggregate robot-steps/s, B x ticks over the slowest rank's time,
    and its ms a tick (rollout_3d runs whole macros of 4 ticks: `steps`
    rounds up to them, and the rate counts the ticks run).

One rank a card (NCCL, the default on the card). Ranks sharing one card
(backend gloo) measure the card's sharing, not scaling. Alone, without
torchrun, it runs one rank. --sp > 1 raises NotImplementedError: the sp
axis splits the 2D grids (parallel/rows.py), and the 3D path's grids are
ROADMAP queue 1's next sp item. On the card unless given --device cpu,
where peak memory is not measured; it raises without a card.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from slam_tpu_torch.parallel import multihost
from slam_tpu_torch.parallel.mesh import require_dp_only
from slam_tpu_torch.pipeline import slam3d
from slam_tpu_torch.run_sim3d import config
from slam_tpu_torch.sim import world3d


def _everyone(x) -> list:
    """x from every rank, in rank order."""
    if not dist.is_initialized():
        return [x]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if dist.is_initialized():
        dist.barrier()


def run(batches, steps: int = 4, sp: int = 1, device=None) -> list:
    """One row a batch (the printed numbers), on every rank."""
    dev = multihost.rank_device(device)
    mesh = multihost.make_fleet_mesh(sp)
    require_dp_only(mesh, "mesh_scaling")
    cfg = config(ref_scale=True)
    world = world3d.make_world(torch.Generator(dev).manual_seed(42),
                               cfg.sim, device=dev)
    ticks = -(-steps // 4) * 4          # rollout_3d's whole macros
    rows = []
    for batch in batches:
        local = multihost.host_local_batch(batch)
        gen = multihost.rank_generator(0, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        st = slam3d.init_state_3d(cfg, local, world, device=dev,
                                  generator=gen)
        gm = slam3d.init_ground_map(cfg, local, device=dev)
        st, gm, _ = slam3d.rollout_3d(st, world, gm, cfg, steps, gen)
        _sync(dev)
        t0 = time.perf_counter()
        st, gm, (est, _, _) = slam3d.rollout_3d(st, world, gm, cfg, steps,
                                                gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) / 1e6
                if dev.type == "cuda" else None)
        every = _everyone((dt, peak, bool(torch.isfinite(est).all())))
        slowest = max(e[0] for e in every)
        rows.append(dict(batch=batch, dp=mesh.shape["dp"], sp=sp,
                         robots_per_rank=local,
                         peak_mb=[e[1] for e in every],
                         rate=batch * ticks / slowest,
                         ms_step=slowest / ticks * 1e3,
                         finite=all(e[2] for e in every)))
        del st, gm, est
    return rows


def line(row: dict, where: str) -> str:
    peaks = ("not measured" if row["peak_mb"][0] is None else
             "[" + ", ".join(f"{p:.1f}" for p in row["peak_mb"]) + "] MB")
    return (f"b{row['batch']:3d} dp{row['dp']} sp{row['sp']}: per-rank peak "
            f"{peaks} (max_memory_allocated), {row['robots_per_rank']:3d} "
            f"robots/rank, {row['rate']:8.1f} robot-steps/s aggregate "
            f"({row['ms_step']:7.1f} ms/step), poses finite "
            f"{row['finite']} | {where}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="16,32,64")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--sp", type=int, default=1,
                    help="spatial shards a robot grid (> 1 raises: the 3D "
                         "path is not split by rows yet)")
    ap.add_argument("--backend", default=None,
                    help="nccl (one rank a card; default on the card) or "
                         "gloo (ranks may share a card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the rank's CUDA card)")
    args = ap.parse_args(argv)
    owned = not dist.is_initialized()
    multihost.init_distributed(backend=args.backend)
    try:
        dev = multihost.rank_device(args.device)
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
        rows = run([int(b) for b in args.batches.split(",")], args.steps,
                   args.sp, dev)
        if multihost.rank() == 0:
            for r in rows:
                print(line(r, f"{multihost.world_size()} rank(s), {where}"),
                      flush=True)
        return rows
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
