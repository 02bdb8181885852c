"""The benchmark's one command (see ``harness.py``):

    python3 chanbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout; ``python3 -m chanbench.run`` does the same.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = _ROOT              # run as a script: the checkout's root
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from chanbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
