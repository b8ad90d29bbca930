"""Run one cell of the port's benchmark and print its result line.

    python3 spindle_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name from
``BENCHMARK.json`` (``configs/<config>.json``, ``traffic/<traffic>.json``,
whose ``driver`` names ``drivers/<driver>.py``); the metrics a cell
reports are the entries of ``BENCHMARK.json`` that list it, each read by
``metrics/<name>.py``.  The last line of standard output is the result
object; everything else goes to standard error or to ``build/`` inside
the checkout.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
