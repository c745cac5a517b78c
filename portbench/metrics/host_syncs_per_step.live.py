"""host_syncs_per_step.live: the deliberate host reads of device values
that the program counts (`host_syncs`: the live loop's converged read an
iteration, the staging's wait for a copy), over the traced slice, a
frame. host_syncs_per_frame.live counts the same from outside, and the
harness's own read of each fused pose besides."""

from portbench.harness import program

CALLS = program.COUNT_CALLS


def read(data):
    counts = program.slice_counts(data)
    if counts is None or not data.get("frames"):
        return None
    return counts["host_syncs"] / data["frames"]
