"""step_ms.live: device-timeline ms of a traced live frame's step, from
its first device operation to its last: the kernels launched under the
live step's spans (program.LIVE_STEP_SPANS) and the idle gaps under them,
summed over the traced frames and divided by them. step_idle_ms.live is
the idle part of it."""

from portbench.harness import program

STAGES = {name: [] for name in program.LIVE_STEP_SPANS}


def read(data):
    spans = program.LIVE_STEP_SPANS
    gaps = [data["gaps_us"][s] for s in spans if s in data["gaps_us"]]
    busy = [data["by_stage_us"][s] for s in spans
            if s in data.get("by_stage_us", {})]
    if not gaps or not busy or not data.get("frames"):
        return None
    return (sum(gaps) + sum(busy)) / 1e3 / data["frames"]
