"""fit_iterations.live: fit iterations a traced live frame ran (the live
loop's steps, each one K4 launch and one graph replay: the program's
`icp.fit_iterations`, counted over the traced slice) over the frames the
slice consumed."""

from portbench.harness import program

CALLS = program.COUNT_CALLS


def read(data):
    counts = program.slice_counts(data)
    if counts is None or not data.get("frames"):
        return None
    return counts["icp.fit_iterations"] / data["frames"]
