"""step_idle_ms.live: device ms a traced live frame in which no device
operation ran while the program's step was under way, summed over the
traced frames and divided by them: the idle gaps under the live step's
spans (program.LIVE_STEP_SPANS: `live.pre`, one `live.iteration` a pass
of the fit's loop, `live.post`). The lead-in from the step's start to its
first device operation lies in the gap before the frame and is not
counted. Read it beside step_ms.live, the step's length in the same
trace: the profiler slows the host's side of each replay and launch, so
both read the profiled step, not the untraced one."""

from portbench.harness import program

STAGES = {name: [] for name in program.LIVE_STEP_SPANS}


def read(data):
    gaps = [data["gaps_us"][s] for s in program.LIVE_STEP_SPANS
            if s in data["gaps_us"]]
    if not gaps or not data.get("frames"):
        return None
    return sum(gaps) / 1e3 / data["frames"]
