"""The benchmark's driver loop: find a cell by name, set it up, measure a
window of its calls, read its metrics, check what the window produced
against the plain reference, and print the result line.

Everything that belongs to one configuration, one traffic mix or one
metric lives in a file of its own under this folder and is found by
name, so a later cell, mix or metric is a new file and no edit here:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``;
* ``metrics/<metric>.py``: one reader, ``read(run) -> float | None``.

A driver module has ``setup(config, traffic, ctx)``, which builds the
system under test from ``ctx.seed``, warms up every shape the cell uses
and returns an object with ``call()`` (one unit of the window's work,
finished on the device when it returns), ``counters()`` (the window's
work), ``release()`` (frees the program's state) and ``checks()`` (a
list of ``(name, value, limit)``: correct where every value is at most
its limit).  The mix's ``trace_calls`` says how many calls the traced
segment of a ``--trace 1`` run makes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_environment() -> None:
    """Import path and caches before torch is imported: the port from
    ``src/``, every build and kernel cache at a fixed path inside the
    checkout, and no JAX pulled in by a library."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: Path, name: str):
    """A module of this folder by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: Dict[str, Any], workload: str):
    """(cell, configuration, traffic) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(bench: Dict[str, Any], workload: str, trace: bool
               ) -> List[Dict[str, Any]]:
    """The metric entries this cell reports in this kind of run."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_trace(fn):
    """Run ``fn()`` under the profiler and reduce the trace: the traced
    wall, the device's busy seconds (the union of its records'
    intervals), each device operation's count and seconds by name, and
    the longest idle gaps named by the CUDA runtime call running across
    each.  Only the device's activity is traced: recording the host's
    operations as well slows a long call several times over and its
    records take minutes to read back."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    ops: Dict[str, List[float]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            lo, hi = e.start_ns(), e.end_ns()
            dev.append((lo, hi))
            rec = ops.setdefault(e.name(), [0, 0.0])
            rec[0] += 1
            rec[1] += (hi - lo) / 1e9
        elif e.device_type() == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    dev.sort()
    busy_ns, gaps, end = 0, [], None
    for lo, hi in dev:
        if end is None or lo > end:
            if end is not None:
                gaps.append((lo - end, end, lo))
            busy_ns += hi - lo
            end = hi
        elif hi > end:
            busy_ns += hi - end
            end = hi
    gaps.sort(reverse=True)
    named: Dict[str, float] = {}
    if host:
        starts = np.array([h[0] for h in host], np.int64)
        ends = np.array([h[1] for h in host], np.int64)
        for length, lo, hi in gaps[:200]:
            mid = (lo + hi) // 2
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = host[cover[np.argmax(starts[cover])]][2] \
                if cover.size else "no runtime call"
            named[name] = named.get(name, 0.0) + length / 1e9
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    top_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return out, {
        "window_s": wall, "busy_s": busy_ns / 1e9,
        "device_ops": sum(c for c, _ in ops.values()), "ops": ops,
        "breakdown": {"device_ops": [[k[:120], v[1]] for k, v in top_ops],
                      "idle_gaps": [[k[:120], v] for k, v in top_gaps]}}


def measure(runner, seconds: float) -> Dict[str, Any]:
    """Calls back to back until ``seconds`` have passed; the window is
    all of them, the last one included."""
    stamps = [time.perf_counter()]
    while True:
        runner.call()
        stamps.append(time.perf_counter())
        if stamps[-1] - stamps[0] >= seconds:
            break
    each = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    log(f"window {stamps[-1] - stamps[0]:.3f} s, {len(each)} calls, "
        f"a call {each[0]:.4f} / {each[len(each) // 2]:.4f} / "
        f"{each[-1]:.4f} s (least / median / most)")
    return {"calls": len(each), "wall_s": stamps[-1] - stamps[0]}


def read_metrics(entries, run) -> Dict[str, Dict[str, Any]]:
    """Each entry's reader over ``run``; a reader with nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 f"spindle_bench_metric_{len(out)}")
            value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool,
            t_start: float, *, device: str = "cuda",
            bench: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of ``workload`` on ``device``: the result object (without
    the device block on a CPU run)."""
    import torch

    bench = bench if bench is not None else load_json(ROOT /
                                                      "BENCHMARK.json")
    cell, config, traffic = cell_spec(bench, workload)
    driver = load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                         f"spindle_bench_driver_{traffic['driver']}")
    if device == "cuda":
        torch.set_num_threads(1)    # one process, few threads: steadier
    ctx = SimpleNamespace(seed=seed, device=device, log=log)
    runner = driver.setup(config, traffic, ctx)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    window = measure(runner, seconds)
    counters = runner.counters()
    traced = None
    if trace:
        n = traffic["trace_calls"]

        def segment():
            for _ in range(n):
                runner.call()
            return runner.counters()

        before = counters
        after, traced = device_trace(segment)
        traced["counters"] = {k: after[k] - before[k] for k in before
                              if isinstance(before[k], (int, float))}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    runner.release()
    checks = runner.checks()
    run = SimpleNamespace(cell=cell, config=config, traffic=traffic,
                          setup_s=setup_s, wall_s=window["wall_s"],
                          calls=window["calls"], counters=counters,
                          trace=traced)
    metrics = read_metrics(metrics_of(bench, workload, trace), run)
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(counters["attempted"]),
              "failed": int(counters["failed"]), "metrics": metrics}
    if device == "cuda":
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
        if traced is not None:
            result["device"]["busy_s"] = traced["busy_s"]
            result["device"]["window_s"] = traced["window_s"]
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    prepare_environment()
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_spec(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " present")
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start, bench=bench)
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
