"""Run one cell of the port's benchmark and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up is timed from the first line here.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0] = ROOT
    from portbench.cachedirs import configure

    configure(ROOT)
    from portbench.harness import main

    sys.exit(main(t0=_T0))
