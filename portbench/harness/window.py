"""The closed-loop window of a simulated fleet, and its check, written once
for every fleet driver: a driver gives its set-up, its macro and its
reference; this module runs the macros back to back, times them, holds
the macros the check compares, profiles the traced slice and runs the
reference over what it held.

A macro is `macro(state, ticks) -> (state, est)`: the public rollout of
`ticks` ticks from `state` (any object: a SlamState, or a tuple of them),
`est` the (B, k) poses whose finiteness counts the failed robot-ticks.
"""

from __future__ import annotations

import gc
import random
import time

from portbench.harness import checks, core, timing, tracing

# the window's macros that the idle share of the traced slice compares
# with (device_idle_share.fleet)
TAIL_MACROS = 8


def gen_at(state, device):
    """A generator on `device` at a saved state."""
    import torch
    g = torch.Generator(device=torch.device(device))
    g.set_state(state)
    return g


def sample(ctx) -> set:
    """The macros the check compares besides the last, drawn from the
    seed among the first `check_before`."""
    p = ctx.traffic
    return set(random.Random(ctx.seed).sample(range(p["check_before"]),
                                              p["check_macros"]))


def closed_loop(ctx, macro, state, gen, held_at: set, until=None,
                device=None) -> dict:
    """Call `macro(state)` back to back until `until(m, elapsed)` (by
    default: --seconds have passed on the host's clock), a CUDA event at
    each macro's boundary with no host wait, and end in a synchronize.
    Holds (state before, generator state before, state after) of the
    macros in `held_at` and of the last. Returns the final state, the
    held macros, the number of macros, the window's seconds, each
    macro's ms and the count of non-finite poses."""
    import torch
    if until is None:
        def until(m, elapsed):
            return elapsed >= ctx.seconds
    held, last = {}, None
    bad = torch.zeros((), dtype=torch.long,
                      device=device or ctx.device)
    marks = timing.Marks(ctx.device)
    marks.mark()
    # no cyclic garbage collection in the window (as live.drain does): a
    # full collection stalls the dispatching thread for milliseconds
    gc.disable()
    t0 = time.perf_counter()
    m = 0
    while not until(m, time.perf_counter() - t0):
        gs = gen.get_state()
        pre = state
        state, est = macro(state)
        bad += (~torch.isfinite(est).all(-1)).sum()
        marks.mark()
        last = (pre, gs, state)
        if m in held_at:
            held[m] = last
        m += 1
    timing.sync(ctx.device)
    seconds = time.perf_counter() - t0
    gc.enable()
    held[m - 1] = last
    return dict(state=state, held=held, macros=m, seconds=seconds,
                ms=marks.intervals_ms(), bad=int(bad))


def run_fleet(ctx, setup, check, extra=None) -> dict:
    """A one-card fleet's run. `setup(ctx) -> (state, gen, macro, ref)`
    makes the fleet from the seed and warms it up; `macro(state, ticks)`
    runs it; `check(ctx, held, ref) -> numbers` compares the held macros
    with the plain reference. `extra` goes into the traced slice's
    data."""
    p = ctx.traffic
    B, T = p["robots"], p["ticks_per_macro"]
    state, gen, macro, ref = setup(ctx)
    setup_s = time.perf_counter() - ctx.t_start
    w = closed_loop(ctx, lambda s: macro(s, T), state, gen, sample(ctx))
    del state
    peak = timing.peak_bytes(ctx.device)
    steps = B * T * w["macros"]
    out = dict(attempted=steps, failed=w["bad"],
               device=core.device_info(ctx.device, 1, peak),
               end_to_end=dict(robot_steps_per_s=steps / w["seconds"],
                               macro_ms_p95=timing.p95(w["ms"]),
                               setup_s=setup_s),
               window=dict(macros=w["macros"], seconds=w["seconds"],
                           macro_ms_median=timing.median(w["ms"])))
    if ctx.trace:
        def run_slice():
            w["state"], _ = macro(w["state"], T * p["trace_macros"])
        data = tracing.profile(run_slice, ctx.cell.readers(), ctx.device)
        # the window's last macros: the slice follows them, and a fleet's
        # macro grows as its maps fill (the window's median lies earlier)
        last = w["ms"][-TAIL_MACROS:]
        data.update(ticks=T * p["trace_macros"],
                    wall_ms_per_tick=sum(last) / len(last) / T,
                    **(extra or {}))
        out["trace"] = data
    del w["state"]
    out["checks"] = check(ctx, w["held"], ref)
    return out


def compare_held(ctx, held: dict, reference, program, compare,
                 control: bool = False) -> list:
    """For each held macro (in order), the reference run from the state
    before it, `reference(pre, gen) -> want`, against `program(post)`,
    or with `control` against the reference computed in TF32 in the
    program's place: the rows of `compare(got, want)`."""
    rows = []
    for _, (pre, gs, post) in sorted(held.items()):
        want = reference(pre, gen_at(gs, ctx.device))
        if control:
            with checks.tf32():
                got = reference(pre, gen_at(gs, ctx.device))
        else:
            got = program(post)
        rows.append(compare(got, want))
        del want, got
    return rows


def hold(ctx, macro, state, gen, macros: int) -> dict:
    """`macros` macros from `state`, each held, for the control."""
    T = ctx.traffic["ticks_per_macro"]
    held = {}
    for m in range(macros):
        gs = gen.get_state()
        pre = state
        state, _ = macro(state, T)
        held[m] = (pre, gs, state)
    return held
