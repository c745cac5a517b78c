"""Closed-loop driver of a simulated 3D fleet (slam3d.rollout_3d): the
fleet window and check (portbench/harness/window.py) over the 3D
rollout, its ground map and the 3D plain reference
(portbench/reference/slam3d.py), with the 2D driver's view and numbers
(portbench/drivers/fleet2d.py). The traffic parameters are fleet2d's.

The check prints, for each checked macro, the robots whose x, y and yaw
were compared, those whose z was, those the reference's collinear-plane
rule left out of z, and the largest pose gap among the latter; a macro
that compares no robot's x and y fails.
"""

from __future__ import annotations

import math
import sys
import time

from portbench.harness import checks, core, timing, window
from portbench.reference import slam3d as ref

fleet2d = core.load_module(core.ROOT, "drivers", "fleet2d")


def view(s, gm) -> dict:
    """The program's state and ground map as the reference's dict."""
    d = fleet2d.view(s)
    sc = s.prev_scene
    g = gm.grid
    d.update(scene_z=sc.xyz[..., 2], scene_drv=(sc.flags & 4) != 0,
             gm_count=g.count, gm_sx=g.sum_x, gm_sy=g.sum_y, gm_sz=g.sum_z,
             gm_center=g.center)
    return d


def compare(prog: dict, want: dict) -> dict:
    """fleet2d's numbers (x, y and the yaw on the robots whose
    registration met no near-tie; a macro that compares none fails),
    pose_m also the gap in x, y and z on the robots whose height met no
    near-tie either (the control's TF32 leaves the height alone, so z is
    compared inside the pose, whose x and y it does move), and the
    ground map. Besides, for the report and not judged: the robots
    compared in x and y, and in z, those the collinear-plane rule leaves
    out of z, and their largest pose gap."""
    import torch
    out = fleet2d.compare(prog, want)
    sv = prog["scene_valid"] & want["scene_valid"]
    far_z = ~(want["near"] | want["near_z"])
    plane = want["near_plane"]
    gap = (prog["pose"][:, [0, 1, 3]].double() -
           want["pose"][:, [0, 1, 3]].double()).norm(dim=-1)
    gap = torch.where(torch.isfinite(gap), gap, math.inf)
    out.update(
        pose_m=max(out["pose_m"], float(gap[far_z].max())
                   if bool(far_z.any()) else 0.0),
        scene_m=max(out["scene_m"], checks.worst(prog["scene_z"],
                                                 want["scene_z"], sv)),
        scene_slots=max(out["scene_slots"], checks.share_differing(
            prog["scene_drv"] & prog["scene_valid"],
            want["scene_drv"] & want["scene_valid"])),
        ground_cells=checks.share_differing(prog["gm_count"],
                                            want["gm_count"]),
        compared=int((~want["near"]).sum()), compared_z=int(far_z.sum()),
        plane_rule=int(plane.sum()),
        plane_gap_m=float(gap[plane].max()) if bool(plane.any()) else 0.0)
    return out


def setup(ctx):
    """fleet2d's set-up over the 3D world, fleet and ground map."""
    import torch
    from slam_tpu_torch.pipeline import slam3d
    from slam_tpu_torch.sim import world3d
    cfg = ctx.slam_config()
    p = ctx.traffic
    T = p["ticks_per_macro"]
    dev = torch.device(ctx.device)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    w = ref.make_world(gen, ctx.config_values["sim"], dev)
    world = world3d.World3D(centers=w[0], radii=w[1], heights=w[2],
                            terrain=w[3], extent=w[4])

    def macro(sg, ticks):
        """The window's call on (state, ground map): the public rollout,
        the maps' upkeep every ticks_per_macro ticks."""
        s, g, (est, _, _) = slam3d.rollout_3d(sg[0], world, sg[1], cfg,
                                              ticks, gen, field_every=T)
        return (s, g), est
    g_init = gen.get_state()
    first = (slam3d.init_state_3d(cfg, p["robots"], world, device=dev,
                                  generator=gen),
             slam3d.init_ground_map(cfg, p["robots"], device=dev))
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
    return window.run_fleet(ctx, setup, check)


REPORTED = ("compared", "compared_z", "plane_rule", "plane_gap_m")


def check(ctx, held, r, control=False) -> dict:
    T = ctx.traffic["ticks_per_macro"]
    vals = ctx.config_values
    w, first, g_init = r

    def reference(pre, gen):
        return ref.macro(view(*pre), w, vals, gen, T)
    rows = window.compare_held(ctx, held, reference, lambda post:
                               view(*post), compare, control)
    B = first[0].pose.shape[0]
    print(f"portbench: robots of {B} compared in x, y and the yaw; in z; "
          "left out of z by the collinear-plane rule; the largest pose gap "
          "(m) among those: " +
          "; ".join(f"{x['compared']}, {x['compared_z']}, {x['plane_rule']}"
                    f", {x['plane_gap_m']:.3g}" for x in rows) +
          " in each checked macro", file=sys.stderr)
    out = fleet2d.worst_of([{k: v for k, v in x.items() if k not in REPORTED}
                            for x in rows])
    out.update(compared_min=min(x["compared"] for x in rows),
               compared_z_min=min(x["compared_z"] for x in rows),
               plane_rule_max=max(x["plane_rule"] for x in rows),
               plane_gap_m=max(x["plane_gap_m"] for x in rows))
    want0 = ref.init_state(window.gen_at(g_init, ctx.device), w, vals, B,
                           ctx.device)
    prog0 = view(*first)
    out["start"] = max(fleet2d.start_gap(prog0, want0),
                       float(prog0["gm_count"].abs().max()))
    return out


def control(ctx, macros: int) -> dict:
    state, gen, macro, r = setup(ctx)
    return check(ctx, window.hold(ctx, macro, state, gen, macros), r,
                 control=True)
