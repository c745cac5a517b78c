"""Closed-loop driver of the particle-filter fleet on one shared map over
ranks (shared_map.fleet_rollout_shared with a mesh): one process a card,
`ranks` of them, joined by torch.distributed (NCCL on the cards; gloo on
the CPU, where a test drives it). The process the benchmark starts is
rank 0; it starts the others (python3 -m portbench.harness.rank), gives
them the rendezvous (tcp://127.0.0.1 on a free port) and waits for each.

Every rank makes the same world from --seed, and its own `robots` from
the seed and its rank; the shared grid starts empty. After
`warmup_macros` macros the window runs one macro a call, back to back;
rank 0 decides when --seconds have passed and every rank stops at the
same macro (through the group's store: no collective, no host wait in
the loop). A macro is `ticks_per_macro` ticks against the shared grid
and then one all-reduce of the fleet's scans; each rank times its macros
by CUDA events, and rank 0 pools them.

The check, on each rank for the macros drawn from the seed and the last:
the plain reference runs the rank's macro from its state and the shared
grid before it (portbench/reference/slam2d.py macro_shared), the ranks
sum their reference deltas, and each rank compares its robots' state
and the merged shared grid. The control puts the reference in TF32 in
the program's place.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

from portbench.harness import checks, core, timing, tracing, window
from portbench.reference import slam2d as ref

RANK_MODULE = "portbench.harness.rank"
STOP = "portbench/stop_at"
TRACE_READY = "portbench/trace_ready"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_first(ctx) -> None:
    """The port's kernel library, built once here before the other ranks
    start (each would build it otherwise)."""
    if ctx.device != "cpu":
        from slam_tpu_torch import cuda_build
        cuda_build.build()


def run(ctx) -> dict:
    """Rank 0: start the other ranks, run, wait for them, return rank 0's
    pooled result."""
    build_first(ctx)
    n = ctx.traffic["ranks"]
    port = free_port()
    args = dict(workload=ctx.cell.name, root=str(ctx.cell.root),
                seed=ctx.seed, seconds=ctx.seconds, trace=ctx.trace,
                device=ctx.device, port=port, world=n)
    env = dict(os.environ, PYTHONPATH=str(core.ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", RANK_MODULE, json.dumps(dict(args, rank=r))],
        cwd=str(core.ROOT), env=env) for r in range(1, n)]
    try:
        out = run_rank(ctx, 0, n, port)
    finally:
        for p in procs:
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return out


def view(s) -> dict:
    d = dict(mu=s.ekf.mu, sigma=s.ekf.sigma, gyro_bias=s.ekf.gyro_bias,
             pose=s.pose, true_pose=s.true_pose, step=s.step.long(),
             reg_pose=s.scan_reg_pose, reg_ok=s.scan_reg_ok,
             occ_counts=s.local_map.counts, occ_drivable=s.local_map.drivable,
             occ_center=s.local_map.center,
             scene_x=s.prev_scene.xyz[..., 0],
             scene_y=s.prev_scene.xyz[..., 1],
             scene_valid=s.prev_scene.valid, scene_ga=s.prev_scene.is_ga())
    return d


def grid_view(g) -> dict:
    return dict(count=g.count, center=g.center, sx=g.sum_x, sy=g.sum_y,
                sz=g.sum_z)


def compare(prog: dict, want: dict, gp: dict, gw: dict) -> dict:
    sv = prog["scene_valid"] & want["scene_valid"]
    return dict(
        pose_m=checks.xy_gap(prog["pose"], want["pose"]),
        yaw_rad=checks.yaw_gap(prog["pose"], want["pose"]),
        pf_pose_m=checks.xy_gap(prog["reg_pose"], want["reg_pose"]),
        ok_robots=checks.share_differing(prog["reg_ok"], want["reg_ok"]),
        scene_m=max(checks.worst(prog["scene_x"], want["scene_x"], sv),
                    checks.worst(prog["scene_y"], want["scene_y"], sv)),
        occupancy_cells=checks.share_differing(prog["occ_counts"],
                                               want["occ_counts"]),
        shared_cells=checks.share_differing(gp["count"], gw["count"]),
        shared_sum_m=max(checks.worst(gp["sx"], gw["sx"]),
                         checks.worst(gp["sy"], gw["sy"])))


def join(ctx, me: int, n: int, port: int):
    """This rank's device, in the process group of the n ranks."""
    import torch
    import torch.distributed as dist
    cuda = ctx.device != "cpu"
    dev = torch.device("cuda", me) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=me)
    return dev


def fleet(ctx, me: int, dev):
    """This rank's fleet from the seed: (cfg, world tensors, world, mesh,
    generator, its state before the fleet, the first state, the empty
    shared grid)."""
    import torch
    from slam_tpu_torch.mapping.point_map import init_point_map
    from slam_tpu_torch.parallel import multihost
    from slam_tpu_torch.pipeline import slam2d
    from slam_tpu_torch.sim import world2d
    cfg = ctx.slam_config()
    w = ref.make_world(torch.Generator(device=dev).manual_seed(ctx.seed),
                       ctx.config_values["sim"], dev)
    world = world2d.World2D(centers=w[0], radii=w[1], extent=w[2])
    gen = torch.Generator(device=dev).manual_seed(ctx.seed * 8 + me + 1)
    g_init = gen.get_state()
    first = slam2d.init_state(cfg, ctx.traffic["robots"], device=dev,
                              generator=gen)
    shared = init_point_map(1, cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0],
                            device=dev)
    return (cfg, w, world, multihost.make_fleet_mesh(), gen, g_init, first,
            shared)


def run_rank(ctx, me: int, n: int, port: int) -> dict:
    import torch.distributed as dist
    from slam_tpu_torch.parallel import shared_map

    dev = join(ctx, me, n, port)
    try:
        store = dist.distributed_c10d._get_default_store()
        p = ctx.traffic
        B, T = p["robots"], p["ticks_per_macro"]
        cfg, w, world, mesh, gen, g_init, first, shared = fleet(ctx, me, dev)

        def macro(sg):
            s, g, (est, _) = shared_map.fleet_rollout_shared(
                sg[0], sg[1], world, cfg, 1, T, generator=gen, mesh=mesh)
            return (s, g), est
        state = (first, shared)
        for _ in range(p["warmup_macros"]):
            state, _ = macro(state)
        timing.sync(ctx.device)
        dist.barrier()
        setup_s = time.perf_counter() - ctx.t_start

        # rank 0 decides when --seconds have passed; every rank stops at
        # the same macro, read through the store (no collective, no host
        # wait in the loop)
        stop_at = None

        def until(m, elapsed):
            nonlocal stop_at
            if stop_at is None and me == 0 and elapsed >= ctx.seconds:
                stop_at = m + p["stop_margin"]
                store.set(STOP, str(stop_at))
            elif stop_at is None and me and store.check([STOP]):
                stop_at = int(store.get(STOP))
            return stop_at is not None and m >= stop_at
        win = window.closed_loop(ctx, macro, state, gen, window.sample(ctx),
                                 until, device=dev)
        dist.barrier()
        peak = timing.peak_bytes(ctx.device)
        mine = dict(ms=win["ms"], bad=win["bad"], peak=peak)
        trace = None
        if ctx.trace:
            def run_slice():
                # every rank's profiler has started before the first
                # traced all-reduce (a barrier through the store, which
                # launches nothing on the card): a rank still starting
                # its profiler would otherwise read as a slow merge
                store.add(TRACE_READY, 1)
                while int(store.add(TRACE_READY, 0)) < n:
                    time.sleep(0.001)
                for _ in range(p["trace_macros"]):
                    win["state"], _ = macro(win["state"])
            trace = tracing.profile(run_slice, ctx.cell.readers(),
                                    ctx.device)
            trace.update(ticks=T * p["trace_macros"],
                         macros=p["trace_macros"],
                         wall_ms_per_tick=timing.median(win["ms"]) / T)
            mine["busy_s"] = trace["busy_s"]
        del state, win["state"]
        mine["checks"] = check(ctx, win["held"], first, g_init, w, B, dev)
        # what this process loaded, for rank 0's look (the result's
        # process is rank 0, but every rank runs a share of the window)
        mine["forbidden"] = core.forbidden_loaded()
        rows = [None] * n
        dist.all_gather_object(rows, mine)
    finally:
        dist.destroy_process_group()
    if me:
        return {}
    found = sorted({m for r in rows for m in r["forbidden"]})
    if found:
        raise core.Forbidden(found)
    pooled = [x for r in rows for x in r["ms"]]
    m = win["macros"]
    out = dict(attempted=n * B * T * m, failed=sum(r["bad"] for r in rows),
               device=core.device_info(ctx.device, n,
                                       max(r["peak"] for r in rows)),
               end_to_end=dict(robot_steps_per_s=n * B * T * m /
                               win["seconds"],
                               macro_ms_p95=timing.p95(pooled),
                               setup_s=setup_s),
               window=dict(macros=m, seconds=win["seconds"]),
               checks=fleet_worst([r["checks"] for r in rows]))
    if ctx.trace:
        trace["busy_s"] = sum(r["busy_s"] for r in rows) / n
        out["trace"] = trace
    return out


def fleet_worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def check(ctx, held, first, g_init, w, B, dev, control=False) -> dict:
    """Every rank runs the reference over its held macros; the deltas are
    summed over the ranks (the reference's own exchange); each rank
    compares its robots and the merged grid. Collective: every rank calls
    it with the same macros."""
    import torch
    import torch.distributed as dist
    vals = ctx.config_values
    T = ctx.traffic["ticks_per_macro"]

    def gen_at(state):
        return window.gen_at(state, dev)

    rows = []
    for _, ((pre, g_pre), gs, (post, g_post)) in sorted(held.items()):
        gp = grid_view(g_pre)
        want, delta = ref.macro_shared(view(pre), w, vals, gen_at(gs), T, gp)
        for k in ("count", "sx", "sy", "sz"):
            dist.all_reduce(delta[k])
        gw = {k: gp[k] + delta[k] for k in ("count", "sx", "sy", "sz")}
        if control:
            with checks.tf32():
                got, d2 = ref.macro_shared(view(pre), w, vals, gen_at(gs),
                                           T, gp)
                for k in ("count", "sx", "sy", "sz"):
                    dist.all_reduce(d2[k])
            gg = {k: gp[k] + d2[k] for k in ("count", "sx", "sy", "sz")}
        else:
            got, gg = view(post), grid_view(g_post)
        rows.append(compare(got, want, gg, gw))
    out = fleet_worst(rows)
    want0 = ref.init_state(gen_at(g_init), vals, B, dev)
    f = view(first)
    out["start"] = max(checks.worst(f[k], want0[k]) for k in
                       ("mu", "sigma", "gyro_bias", "pose", "true_pose"))
    return out


def control_rank(ctx, me, n, port, macros) -> dict:
    """The control's readings on every rank (calibrate.py, through
    portbench.harness.rank): set up as a run does, `macros` macros held,
    the reference in TF32 against the reference."""
    import torch.distributed as dist
    from slam_tpu_torch.parallel import shared_map
    dev = join(ctx, me, n, port)
    try:
        p = ctx.traffic
        B, T = p["robots"], p["ticks_per_macro"]
        cfg, w, world, mesh, gen, g_init, first, shared = fleet(ctx, me, dev)
        state, held = first, {}
        for m in range(p["warmup_macros"] + macros):
            gs = gen.get_state()
            pre = (state, shared)
            state, shared, _ = shared_map.fleet_rollout_shared(
                state, shared, world, cfg, 1, T, generator=gen, mesh=mesh)
            if m >= p["warmup_macros"]:
                held[m] = (pre, gs, (state, shared))
        numbers = check(ctx, held, first, g_init, w, B, dev, control=True)
        rows = [None] * n
        dist.all_gather_object(rows, numbers)
    finally:
        dist.destroy_process_group()
    return fleet_worst(rows)


def control(ctx, macros: int) -> dict:
    build_first(ctx)
    n = ctx.traffic["ranks"]
    port = free_port()
    args = dict(workload=ctx.cell.name, root=str(ctx.cell.root),
                seed=ctx.seed, seconds=ctx.seconds, trace=False,
                device=ctx.device, port=port, world=n, control=macros)
    env = dict(os.environ, PYTHONPATH=str(core.ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", RANK_MODULE, json.dumps(dict(args, rank=r))],
        cwd=str(core.ROOT), env=env) for r in range(1, n)]
    try:
        return control_rank(ctx, 0, n, port, macros)
    finally:
        for p in procs:
            p.wait(timeout=300)
