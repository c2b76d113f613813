"""``python -m portbench --workload <name> --seed <n> --seconds <s>
--trace 0|1``: one run of one cell; see ``portbench/harness.py``."""

import time

_T_START = time.perf_counter()   # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, so the port imports from the tree being measured
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=_T_START))
