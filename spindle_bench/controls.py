"""Read a cell's compared numbers for the program and for its control on
many seeds, at the cell's own size, to set and keep its limits:

    python3 spindle_bench/controls.py --workload <cell> --seeds 1 2 3

Prints one JSON line per seed.  The benchmark's own runs never run the
control."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def main(argv) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--faults", action="store_true",
                   help="the planted faults' readings instead")
    args = p.parse_args(argv)
    harness.prepare_environment()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, config, traffic = harness.cell_spec(bench, args.workload)
    driver = harness.load_module(
        harness.BENCH / "drivers" / f"{traffic['driver']}.py", "driver")
    ctx = SimpleNamespace(seed=args.seeds[0], device=args.device,
                          log=harness.log, seconds=bench["run_seconds"])
    t0 = time.perf_counter()
    read = driver.fault_readings if args.faults else \
        driver.control_readings
    for row in read(config, traffic, ctx, args.seeds):
        row["t_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
