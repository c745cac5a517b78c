"""host_syncs_per_step.fleet: the deliberate host reads of device values
that the program counts (`host_syncs`: the fits' converged reads, a
relocalization gate's flag, metrics and nan_debug reads), over the traced
slice, a tick. A fleet's tick makes none: any is a wait for the card."""

from portbench.harness import program

CALLS = program.COUNT_CALLS


def read(data):
    counts = program.slice_counts(data)
    if counts is None or not data.get("ticks"):
        return None
    return counts["host_syncs"] / data["ticks"]
