"""Closed-loop driver of a simulated 2D fleet (slam2d.rollout).

The world, the robots and every noise draw come from --seed through one
torch.Generator on the device. After `warmup_macros` macros of set-up the
window calls the public rollout one macro (`ticks_per_macro` ticks) at a
time, back to back, until --seconds have passed on the host's clock, and
ends in a synchronize. A CUDA event recorded at every macro boundary, with
no host wait, times each macro.

Traffic parameters: robots, ticks_per_macro, warmup_macros, check_macros
(macros drawn from the seed among the first check_before, whose outputs
are checked besides the window's last macro), trace_macros (the profiled
slice after the window).

The check: the program's state before each checked macro, with the
generator's state there, is handed to the plain reference
(portbench/reference/slam2d.py), which runs the macro again; its outputs
are compared with the program's state after it. The reference follows
the program macro by macro from the program's own state: over a window of
hundreds of macros a SLAM fleet's trajectories part at the first near-tie
of a nearest-point search, so a whole-window comparison would measure
that, not the program. The start (the fleet's first state, from the same
draws) is checked by itself.
"""

from __future__ import annotations

import math
import sys
import time

from portbench.harness import checks, timing, window
from portbench.reference import slam2d as ref


def view(s) -> dict:
    """The program's SlamState as the reference's dict of tensors."""
    mc, sc = s.prev_scene, s.map_cloud
    d = dict(mu=s.ekf.mu, sigma=s.ekf.sigma, gyro_bias=s.ekf.gyro_bias,
             pose=s.pose, true_pose=s.true_pose, step=s.step.long(),
             reg_pose=s.scan_reg_pose, reg_ok=s.scan_reg_ok,
             occ_counts=s.local_map.counts,
             occ_drivable=s.local_map.drivable,
             occ_center=s.local_map.center,
             scene_x=mc.xyz[..., 0], scene_y=mc.xyz[..., 1],
             scene_valid=mc.valid, scene_ga=mc.is_ga(),
             tgt_x=sc.xyz[..., 0], tgt_y=sc.xyz[..., 1],
             tgt_z=sc.xyz[..., 2], tgt_ga=sc.is_ga(), tgt_valid=sc.valid)
    g = s.map_grid
    if g is not None:
        d.update(pm_count=g.count, pm_sx=g.sum_x, pm_sy=g.sum_y,
                 pm_sz=g.sum_z, pm_center=g.center)
    return d


def compare(prog: dict, want: dict) -> dict:
    """The numbers compared after a macro, program against reference."""
    sv = prog["scene_valid"] & want["scene_valid"]
    tv = prog["tgt_valid"] & want["tgt_valid"]
    # poses are compared on the robots whose registration met no near-tie
    # in the reference (reference/slam2d.py NEAR), the maps on every
    # robot; a macro that leaves every robot out compares no pose, and
    # fails
    far = ~want["near"]
    none = math.inf if not bool(far.any()) else 0.0
    return dict(
        pose_m=max(none, checks.xy_gap(prog["pose"][far], want["pose"][far])),
        yaw_rad=max(none, checks.yaw_gap(prog["pose"][far],
                                         want["pose"][far])),
        ok_robots=checks.share_differing(prog["reg_ok"], want["reg_ok"]),
        scene_m=max(checks.worst(prog["scene_x"], want["scene_x"], sv),
                    checks.worst(prog["scene_y"], want["scene_y"], sv)),
        scene_slots=checks.share_differing(
            prog["scene_valid"] | (prog["scene_ga"] << 1),
            want["scene_valid"] | (want["scene_ga"] << 1)),
        target_m=max(checks.worst(prog["tgt_x"], want["tgt_x"], tv),
                     checks.worst(prog["tgt_y"], want["tgt_y"], tv)),
        target_slots=checks.share_differing(
            prog["tgt_valid"] | (prog["tgt_ga"] << 1),
            want["tgt_valid"] | (want["tgt_ga"] << 1)),
        map_cells=checks.share_differing(prog["pm_count"],
                                         want["pm_count"]),
        occupancy_cells=checks.share_differing(prog["occ_counts"],
                                               want["occ_counts"]))


def start_gap(prog: dict, want: dict) -> float:
    """Largest difference of the fleet's first state from the
    reference's (the EKF and the gyro bias; the maps start empty)."""
    gaps = [checks.worst(prog[k], want[k]) for k in
            ("mu", "sigma", "gyro_bias", "pose", "true_pose")]
    gaps += [float(prog[k].abs().max()) for k in
             ("pm_count", "occ_counts")]
    return max(gaps)


def report_near(shares: list) -> None:
    print("portbench: robots with a near-tie in the reference's fit, left "
          "out of the pose comparison: " +
          ", ".join(f"{x:.4f}" for x in shares) + " of each checked macro",
          file=sys.stderr)


def worst_of(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def setup(ctx):
    """World, fleet and warm-up: (state, generator, the macro, what the
    check needs: the world's tensors, the first state, the generator's
    state before it)."""
    import torch
    from slam_tpu_torch.pipeline import slam2d
    from slam_tpu_torch.sim import world2d
    cfg = ctx.slam_config()
    p = ctx.traffic
    T = p["ticks_per_macro"]
    dev = torch.device(ctx.device)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    w = ref.make_world(gen, ctx.config_values["sim"], dev)
    world = world2d.World2D(centers=w[0], radii=w[1], extent=w[2])

    def macro(state, ticks):
        """The window's call: the public rollout, the map's upkeep every
        ticks_per_macro ticks."""
        state, (est, _) = slam2d.rollout(state, world, cfg, ticks, gen,
                                         field_every=T)
        return state, est
    g_init = gen.get_state()
    first = slam2d.init_state(cfg, p["robots"], device=dev, generator=gen)
    state = first
    timing.sync(ctx.device)
    t_warm = time.perf_counter()
    for _ in range(p["warmup_macros"]):
        state, _ = macro(state, T)
    timing.sync(ctx.device)
    print(f"portbench: set-up: {t_warm - ctx.t_start:.3f} s to the fleet's "
          f"first state, {time.perf_counter() - t_warm:.3f} s of warm-up",
          file=sys.stderr)
    return state, gen, macro, (w, first, g_init)


def run(ctx) -> dict:
    return window.run_fleet(ctx, setup, check,
                            extra=dict(icp=ctx.config_values["icp"]))


def check(ctx, held: dict, r, control: bool = False) -> dict:
    """Run the reference over each held macro and compare. With
    `control`, the reference computed with TF32 on stands in the
    program's place."""
    T = ctx.traffic["ticks_per_macro"]
    vals = ctx.config_values
    w, first, g_init = r
    near = []

    def reference(pre, gen):
        want = ref.macro(view(pre), w, vals, gen, T)
        near.append(float(want["near"].float().mean()))
        return want
    rows = window.compare_held(ctx, held, reference, view, compare, control)
    report_near(near[::2] if control else near)
    out = worst_of(rows)
    want0 = ref.init_state(window.gen_at(g_init, ctx.device), vals,
                           first.pose.shape[0], ctx.device)
    out["start"] = start_gap(view(first), want0)
    return out


def control(ctx, macros: int) -> dict:
    """The control's readings: set up as a run does, run `macros` macros,
    hold each, and compare the reference with TF32 on against it."""
    state, gen, macro, r = setup(ctx)
    return check(ctx, window.hold(ctx, macro, state, gen, macros), r,
                 control=True)
