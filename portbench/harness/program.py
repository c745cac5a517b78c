"""What the program's own counters (slam_tpu_torch/utils/profiling.py) say
about a traced slice, for the readers of program_counter metrics.

A reader declares `CALLS = program.COUNT_CALLS` (empty where the program
has no counter registry, as before it had one): every `profiling.count(
name, n)` the slice makes is then kept, by the harness's own mechanism for
recorded calls, and `slice_counts` sums them by name. Device counters
(the kernels' fit iterations) are never counted on the host in a tick:
`totals` reads the registry's snapshot after the run, and those counters
only grow while a profiler records, so in a benchmark run, whose one
profiled session is the traced slice, their totals are the slice's.
"""

from __future__ import annotations

import collections


def _registry():
    """The program's counter registry module, or None without one."""
    try:
        from slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "counters") else None


COUNT_CALLS = ({"program_counts": "slam_tpu_torch.utils.profiling:count"}
               if _registry() is not None else {})

# the live step's spans (live.GraphedStep.__call__): named as STAGES labels
# with no function to wrap, so the harness's attribution counts each kernel
# and idle gap inside the step toward the one of them open at its launch or
# middle; a program without them leaves those labels empty
LIVE_STEP_SPANS = ("live.pre", "live.iteration", "live.post")


def slice_counts(data: dict):
    """{name: the slice's total} of the kept count calls (none kept: all
    0), or None where the program has no counter registry."""
    if not COUNT_CALLS:
        return None
    out = collections.Counter()
    for a, k in data.get("calls", {}).get("program_counts", []):
        args = dict(zip(("name", "n"), a), **k)
        out[args["name"]] += args.get("n", 1)
    return out


def totals():
    """The registry's snapshot (device counters read to the host), or None
    without a registry."""
    reg = _registry()
    return None if reg is None else reg.counters()
