"""A rank of a multi-process cell with one fault planted, for
test_portbench_shared.py: python3 -m portbench.tests.fault_rank <fault>
'<the rank's json>'."""

import sys

from portbench.tests.test_portbench_shared import plant

if __name__ == "__main__":
    import pytest
    mp = pytest.MonkeyPatch()
    plant(mp, sys.argv[1])
    from portbench.harness import rank
    sys.exit(rank.main(sys.argv[2:]))
