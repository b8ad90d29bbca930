#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the SMC-sweep kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch twin on the card, then drives the port's
main path — ``Group.run`` and ``Group.run_batch`` on the ``kernel``
backend — at the paper's deployment sizes and checks that the card's
``kernel`` and ``graph`` runs and the CPU ``graph`` run agree exactly.

Phases (one JSON line each; any failure exits non-zero):

0. card identity (``nvidia-smi`` name and power limit) and build time;
1. both kernels against their twins at the main path's lane counts and
   at 2**20 lanes: exact equality, CUDA-event times, the byte bound;
2. the paper's testbed: 16 nodes, all senders, 10 KB messages, window
   100, 1000 messages per sender;
3. the Fig. 6 window grid and the Fig. 11 null-send grid as one
   ``run_batch`` each, every point equal to its own sequential run;
4. a heterogeneous 64-topic DDS domain over 16 nodes (the masked kernel
   path);
5. the ``kernels`` line: per kernel its launches on the main path
   (phases 2-4), its times and its bound.

The round loop of every card ``kernel`` run executes under
``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
inside it fails the run.  The last line is the device record.  Needs one
CUDA GPU and ``nvcc``; exits 2 without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.core.group import (GraphBackend, KernelBackend,  # noqa: E402
                                    _stack_masks)
from repro_torch.kernels import smc_sweep as ss  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
# The card's table has no int32 ALU rate; slot checks are charged at the
# fp32 non-tensor-core peak (67 TFLOP/s), one operation per check.
ALU_OPS_PER_S = 67e12
RTOL_FLOAT = 1e-6             # float report fields (FMA / summation order)

INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled")
FLOAT_FIELDS = ("throughput_GBps", "mean_latency_us", "p99_latency_us",
                "duration_us")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int):
    """Mean time the device spent in kernels per ``fn()`` call, from the
    profiler's device-side trace (launch gaps excluded); None if the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def same_logs(a, b, what: str) -> None:
    check(a.keys() == b.keys(), f"{what}: subgroups differ")
    for gid in a:
        la, lb = a[gid], b[gid]
        check(la.delivered_seq == lb.delivered_seq,
              f"{what}: delivered_seq differs in subgroup {gid}")
        check(len(la.is_app) == len(lb.is_app)
              and all(np.array_equal(x, y)
                      for x, y in zip(la.is_app, lb.is_app)),
              f"{what}: is_app differs in subgroup {gid}")


def same_report(ra, rb, what: str) -> None:
    for f in INT_FIELDS:
        check(getattr(ra, f) == getattr(rb, f),
              f"{what}: {f} {getattr(ra, f)} != {getattr(rb, f)}")
    for f in FLOAT_FIELDS:
        check(np.allclose(getattr(ra, f), getattr(rb, f), rtol=RTOL_FLOAT,
                          atol=0.0),
              f"{what}: {f} {getattr(ra, f)} vs {getattr(rb, f)}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase0_identity():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    ss.build()
    build_s = time.perf_counter() - t0
    emit({"phase": 0, "nvidia_smi": smi_line,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s})
    return smi_line


def lane_inputs(n: int, window: int, seed: int):
    """Seeded lanes: half near a realistic receive (published within a
    window or two of processed), half arbitrary, with negative processed
    counts among both; plus a random validity mask."""
    rng = np.random.default_rng(seed)
    processed = rng.integers(-2 * window, 4 * window, size=n)
    near = processed + rng.integers(-1, window + 2, size=n)
    wild = rng.integers(-window, 6 * window, size=n)
    published = np.where(rng.random(n) < 0.5, near, wild)
    valid = rng.random(n) < 0.8
    dev = torch.device("cuda")
    as_dev = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)
    return as_dev(published), as_dev(processed), as_dev(valid)


def phase1_kernels(shapes):
    """Each kernel against its twin on the card, exact; times per shape."""
    rows = []
    for label, n, window in shapes:
        pub, proc, valid = lane_inputs(n, window, seed=n + window)
        counters = ss.counters_from_counts(pub, window).contiguous()
        cases = {
            "smc_sweep_watermark": (
                lambda: ss.smc_sweep_watermark(pub, proc, window=window),
                lambda: ss.smc_sweep_watermark_plain(pub, proc, window)),
            "smc_sweep_watermark_masked": (
                lambda: ss.smc_sweep_watermark(pub, proc, window=window,
                                               valid=valid),
                lambda: ss.smc_sweep_watermark_plain(pub, proc, window,
                                                     valid)),
            "smc_sweep": (lambda: ss.smc_sweep(counters, proc),
                          lambda: ss.smc_sweep_plain(counters, proc)),
        }
        want_plain = None
        for name, (kernel, plain) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            check(err == 0 and got.dtype == torch.int32,
                  f"{name} at {label} ({n} lanes, W={window}) differs "
                  f"from its twin by {err}")
            if name == "smc_sweep_watermark":
                want_plain = want
            if name == "smc_sweep":   # the ring oracle of the watermark form
                check(torch.equal(got, want_plain),
                      f"ring sweep != watermark sweep at {label}")
            big = n >= 1 << 18
            kernel_ms = cuda_ms(kernel, 50 if big else 200)
            kernel_device_ms = profiled_device_ms(kernel, 50)
            plain_ms = cuda_ms(plain, 5 if big else 50, warmup=2)
            run = (want - proc).clamp(min=0)
            if name == "smc_sweep_watermark_masked":
                checks = int(torch.where(valid > 0,
                                         (run + 1).clamp(max=window),
                                         0).sum().item())
            else:
                checks = int((run + 1).clamp(max=window).sum().item())
            inputs = counters.numel() + n if name == "smc_sweep" else \
                (3 if name.endswith("masked") else 2) * n
            nbytes = 4 * (inputs + n)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = checks / ALU_OPS_PER_S * 1e3
            rows.append({"kernel": name, "shape": label, "lanes": n,
                         "window": window, "max_abs_err": err,
                         "ms": kernel_ms, "device_ms": kernel_device_ms,
                         "plain_ms": plain_ms, "bytes": nbytes, "slot_checks": checks,
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations"})
        yard_ms = cuda_ms(lambda: proc + torch.clamp(pub - proc, 0, window),
                          50 if n >= 1 << 18 else 200)
        for r in rows[-len(cases):]:
            r["yardstick_ms"] = yard_ms
            emit({"phase": 1, **r})
    return rows


class SyncCheckedKernelBackend(KernelBackend):
    """The ``kernel`` backend with its device part (round loop and cost
    fold) run under ``set_sync_debug_mode("error")``: a host
    synchronisation inside the loop raises."""

    def _execute(self, *args):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return super()._execute(*args)
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def timed_run(group, backend):
    t0 = time.perf_counter()
    report = group.run(backend=backend)
    return report, time.perf_counter() - t0


def phase2_testbed():
    cfg = api.single_group(16, msg_size=10240, window=100, n_messages=1000)
    out = {}
    walls = {}
    for key, device, backend in (
            ("kernel_cuda", "cuda", SyncCheckedKernelBackend("cuda")),
            ("graph_cuda", "cuda", "graph"),
            ("graph_cpu", "cpu", "graph")):
        g = api.Group(cfg, device=device)
        timed_run(g, backend)                           # cold
        before = ss.WATERMARK_LAUNCHES
        report, wall = timed_run(g, backend)            # warm
        launches = ss.WATERMARK_LAUNCHES - before
        if key == "kernel_cuda":
            check(launches == report.rounds,
                  f"testbed: {launches} kernel launches for "
                  f"{report.rounds} rounds")
        else:
            check(launches == 0, f"testbed {key} launched the kernel")
        check(not report.stalled, f"testbed {key} stalled")
        check(report.delivered_app_msgs == 16 * 16 * 1000,
              f"testbed {key}: {report.delivered_app_msgs} app deliveries")
        out[key] = (report, dict(g.delivery_logs))
        walls[key] = {"wall_s": wall, "per_round_ms":
                      wall / report.rounds * 1e3, "launches": launches}
    ref_report, ref_logs = out["graph_cpu"]
    for key in ("kernel_cuda", "graph_cuda"):
        same_logs(out[key][1], ref_logs, f"testbed {key} vs graph_cpu")
        same_report(out[key][0], ref_report, f"testbed {key} vs graph_cpu")
    emit({"phase": 2, "scenario": "single_group(16, msg_size=10240, "
          "window=100, n_messages=1000)", "rounds": ref_report.rounds,
          "identical": True, **walls,
          "profile_kernel_cuda": profile_run(cfg),
          "summary": ref_report.summary()})


def profile_run(cfg):
    """Where a warm card ``kernel`` run's time goes: device kernel time
    against host wall time, from the profiler's device-side trace."""
    from torch.profiler import ProfilerActivity, profile
    g = api.Group(cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        report, wall = timed_run(g, SyncCheckedKernelBackend("cuda"))
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy_us = sum(device_us(e) for e in events)
    sweep = [e for e in events if "smc_sweep_watermark_kernel" in e.key]
    sweep_us = sum(device_us(e) for e in sweep)
    sweep_n = sum(e.count for e in sweep)
    top = sorted(events, key=device_us, reverse=True)[:5]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ops_per_round": sum(e.count for e in events)
            / report.rounds,
            "sweep_kernel_launches": sweep_n,
            "sweep_kernel_us_per_launch": sweep_us / sweep_n
            if sweep_n else None,
            "top_device_ops_us": {e.key[:60]: device_us(e) for e in top}}


def phase3_grids():
    rows = {}
    grids = (
        ("fig6_windows", api.single_group(16, msg_size=10240, n_messages=800),
         {"windows": [5, 20, 100, 500, 1000]}),
        ("fig11_null_send",
         api.single_group(16, msg_size=10240, n_messages=1200),
         {"null_send": [True, False]}))
    for label, cfg, grid in grids:
        g = api.Group(cfg, device="cuda")
        before = ss.WATERMARK_LAUNCHES
        t0 = time.perf_counter()
        reports = g.run_batch(backend=SyncCheckedKernelBackend("cuda"),
                              **grid)
        wall = time.perf_counter() - t0
        launches = ss.WATERMARK_LAUNCHES - before
        t_max = max(r.rounds for r in reports)
        check(launches == t_max, f"{label}: {launches} launches for a "
              f"{t_max}-round grid (want one per round)")
        (key, values), = grid.items()
        for value, report in zip(values, reports):
            if key == "windows":
                over = {"subgroups": tuple(dataclasses.replace(
                    s, window=value) for s in cfg.subgroups)}
            else:
                over = {"flags": dataclasses.replace(cfg.flags,
                                                     null_send=value)}
            solo = api.Group(dataclasses.replace(cfg, **over),
                             device="cuda")
            solo_report = solo.run(backend=SyncCheckedKernelBackend("cuda"))
            same_logs(report.extras["delivery_logs"], solo.delivery_logs,
                      f"{label} point {value}")
            same_report(report, solo_report, f"{label} point {value}")
        rows[label] = {"points": len(reports), "rounds": t_max,
                       "launches": launches, "batch_wall_s": wall,
                       "per_point": [r.summary() for r in reports]}
    emit({"phase": 3, "identical_to_sequential": True, **rows})


def dds_domain():
    """16 nodes, 64 topics: topic t has 1 + t % 4 publishers and
    2 + t % 11 subscribers, windows alternating 16/100, 4 KB samples."""
    d = api.Domain(n_nodes=16)
    for t in range(64):
        n_pub, n_sub = 1 + t % 4, 2 + t % 11
        nodes = [(t + i) % 16 for i in range(n_pub + n_sub)]
        d.create_topic(f"topic-{t}", publishers=nodes[:n_pub],
                       subscribers=nodes[n_pub:], sample_size=4096,
                       window=16 if t % 2 == 0 else 100)
    return d


def dds_lanes() -> int:
    topics = dds_domain().topics
    return len(topics) * max(len(t.members) for t in topics) * \
        max(len(t.publishers) for t in topics)


def phase4_dds():
    out, walls = {}, {}
    for key, device, backend in (
            ("kernel_cuda", "cuda", SyncCheckedKernelBackend("cuda")),
            ("graph_cuda", "cuda", "graph"),
            ("graph_cpu", "cpu", "graph")):
        g = dds_domain().group(samples_per_publisher=200, device=device)
        before = ss.WATERMARK_LAUNCHES
        report, wall = timed_run(g, backend)
        launches = ss.WATERMARK_LAUNCHES - before
        cfg = g.cfg
        t_max = max(GraphBackend._rounds_for(cfg, spec, g.send_counts(i))
                    for i, spec in enumerate(cfg.subgroups))
        if key == "kernel_cuda":
            masks = _stack_masks(tuple(len(s.members) for s in cfg.subgroups),
                                 tuple(len(s.senders) for s in cfg.subgroups))
            check(masks[0] is not None, "DDS stack is not heterogeneous")
            check(launches == t_max, f"DDS: {launches} launches for "
                  f"{t_max} rounds")
        check(not report.stalled, f"DDS {key} stalled")
        out[key] = (report, dict(g.delivery_logs))
        walls[key] = {"wall_s": wall, "rounds": t_max, "launches": launches}
    for key in ("kernel_cuda", "graph_cuda"):
        same_logs(out[key][1], out["graph_cpu"][1], f"DDS {key} vs graph_cpu")
        same_report(out[key][0], out["graph_cpu"][0],
                    f"DDS {key} vs graph_cpu")
    emit({"phase": 4, "topics": 64, "nodes": 16, "lanes": dds_lanes(),
          "identical": True, **walls,
          "summary": out["graph_cpu"][0].summary()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    phase0_identity()
    shapes = (("group16", 16 * 16, 100), ("fig6_grid", 5 * 16 * 16, 1000),
              ("dds_stack", dds_lanes(), 100), ("large", 1 << 20, 100))
    rows = phase1_kernels(shapes)

    ss.reset_launch_counts()                  # the main path starts here
    phase2_testbed()
    phase3_grids()
    phase4_dds()
    launches = ss.launch_counts()             # ... and ends here
    check(launches["smc_sweep_watermark"] > 0,
          "the main path never launched the watermark kernel")

    def main_shape(kernel):
        return next(r for r in rows
                    if r["kernel"] == kernel and r["shape"] == "group16")

    kernels = []
    for name, replaces, source in (
            ("smc_sweep_watermark",
             "src/repro/kernels/smc_sweep.py:153 smc_sweep_watermark_pallas",
             "src/repro_torch/kernels/csrc/smc_sweep.cu"),
            ("smc_sweep", "src/repro/kernels/smc_sweep.py:127 "
             "smc_sweep_pallas", "src/repro_torch/kernels/csrc/smc_sweep.cu")):
        r = main_shape(name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "on_main_path": name == "smc_sweep_watermark",
            "exact": all(x["max_abs_err"] == 0 for x in rows
                         if x["kernel"].startswith(name)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "yardstick_ms": r["yardstick_ms"],
            "shape": f"{r['lanes']} lanes, W={r['window']}"})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
