"""A rank other than 0 of a cell that runs over several processes,
started by its driver:

    python3 -m portbench.harness.rank '<json: workload, root, seed,
        seconds, trace, device, port, world, rank[, control]>'

It runs the driver's run_rank (or, with "control", control_rank) and
prints nothing on standard output: rank 0 prints the result."""

import json
import sys
import time
from pathlib import Path


def main(argv) -> int:
    t_start = time.perf_counter()
    a = json.loads(argv[0])
    from portbench.harness import core
    cell = core.Cell(a["workload"], root=Path(a["root"]))
    core.use_checkout_caches(cell.root)
    import torch
    torch.set_num_threads(1)
    ctx = core.Context(cell, a["seed"], a["seconds"], a["trace"],
                       a["device"], t_start)
    driver = cell.driver()
    if "control" in a:
        driver.control_rank(ctx, a["rank"], a["world"], a["port"],
                            a["control"])
    else:
        driver.run_rank(ctx, a["rank"], a["world"], a["port"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
