"""One run of one cell of the port's benchmark:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md."""

import sys
import time

T0 = time.perf_counter()        # set-up is counted from here

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)         # the checkout, not portbench/, is the root

from portbench.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T0))
