"""Readings for the limits of a cell's output check, in one process on
the card: the program's compared numbers on each of --seeds (each a run
of --seconds, as the benchmark runs it) and the control's (the plain
reference computed in TF32 in the program's place, over
--control-length macros, or frames live) on each of --control-seeds. One JSON line per reading, also
written to --out.

    python3 portbench/calibrate.py --workload sim2d.fused.b4096 \
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 4

With --witness-seeds (a 3D cell), the witness of the collinear-plane
rule (reference/slam3d.py plane_normal): the fleet runs
--witness-macros macros, the reference follows each from the program's
state, and on the robots the rule leaves out the program's pose is
compared with the reference's; where they part by more than the cell's
pose limit, the reference runs that macro again with the program's own
closed-form plane fit (slam_tpu_torch.ops.height) in its place, in
float32 and in float64, and the gaps to each are reported.

The benchmark's own runs never run the control or the witness."""

import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from portbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-length", type=int, default=3,
                    help="macros (fleet) or frames (live) the control runs")
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-macros", type=int, default=20)
    ap.add_argument("--out", default="build/portbench/calibrate.jsonl")
    args = ap.parse_args(argv)
    cell = core.Cell(args.workload)
    core.use_checkout_caches(cell.root)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    driver = cell.driver()
    with open(args.out, "a") as f:
        def emit(row):
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
            f.flush()
        for seed in args.seeds:
            ctx = core.Context(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter())
            out = driver.run(ctx)
            emit(dict(workload=args.workload, kind="program", seed=seed,
                      numbers=out["checks"], failed=out["failed"],
                      end_to_end=out["end_to_end"]))
            del out
            torch.cuda.empty_cache()
        for seed in args.control_seeds:
            ctx = core.Context(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter())
            emit(dict(workload=args.workload, kind="control", seed=seed,
                      numbers=driver.control(ctx, args.control_length)))
            torch.cuda.empty_cache()
        for seed in args.witness_seeds:
            ctx = core.Context(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter())
            for row in witness(driver, ctx, args.witness_macros):
                emit(dict(workload=args.workload, kind="witness", seed=seed,
                          **row))
            torch.cuda.empty_cache()
    return 0


def witness(driver, ctx, macros: int):
    """Rows, one a macro, of the collinear-plane rule's witness (see the
    module's docstring); gaps in m over x, y and z."""
    import torch

    from portbench.harness import window
    from portbench.reference import slam3d as ref
    from slam_tpu_torch.ops import height
    eigh = ref.plane_normal

    def closed_form(dtype):
        def normal(pts, w):
            n = height._plane_normal(pts.to(dtype), w.to(dtype)).float()
            return torch.where(n[:, 2:3] < 0, -n, n), eigh(pts, w)[1]
        return normal

    def gap(a, b, rows):
        d = (a["pose"][:, [0, 1, 3]].double() -
             b["pose"][:, [0, 1, 3]].double()).norm(dim=-1)[rows]
        return float(d.max()) if d.numel() else 0.0
    T = ctx.traffic["ticks_per_macro"]
    limit = ctx.cell.limits["pose_m"]
    state, gen, macro, (w, _, _) = driver.setup(ctx)
    for m in range(macros):
        gs = gen.get_state()
        pre = state
        state, _ = macro(state, T)
        got = driver.view(*state)

        def reference(normal):
            ref.plane_normal = normal
            try:
                return ref.macro(driver.view(*pre), w, ctx.config_values,
                                 window.gen_at(gs, ctx.device), T)
            finally:
                ref.plane_normal = eigh
        want = reference(eigh)
        plane = want["near_plane"]
        row = dict(macro=m, plane_rule=int(plane.sum()),
                   program_reference_m=gap(got, want, plane))
        if row["program_reference_m"] > limit:
            parted = plane & ((got["pose"][:, [0, 1, 3]] -
                               want["pose"][:, [0, 1, 3]]).norm(dim=-1)
                              > limit)
            f32, f64 = (reference(closed_form(t))
                        for t in (torch.float32, torch.float64))
            row.update(parted=int(parted.sum()),
                       program_closed_form32_m=gap(got, f32, parted),
                       reference_closed_form64_m=gap(want, f64, parted),
                       program_closed_form64_m=gap(got, f64, parted))
        yield row
        del pre, got, want


if __name__ == "__main__":
    sys.exit(main())
