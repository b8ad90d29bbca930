"""The benchmark's cells on the CPU at tiny shapes: the result line, the
references against the port's CPU path, the controls and the planted
faults."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import harness
from tiny import tiny_bench

CELLS = ("tiny.saturate", "tiny.decode", "tiny.train")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


def run_cell(bench, cell, seed=20260917, trace=False):
    return harness.execute(cell, seed, 0.5, trace, time.perf_counter(),
                           device="cpu", bench=bench)


def runner_of(bench, cell, seed=7):
    c, config, traffic = harness.cell_spec(bench, cell)
    driver = harness.load_module(
        harness.BENCH / "drivers" / f"{traffic['driver']}.py",
        f"test_driver_{traffic['driver']}")
    ctx = SimpleNamespace(seed=seed, device="cpu", log=lambda m: None)
    return driver, config, traffic, ctx


def same_driver(driver):
    """``harness.load_module`` handing the run the test's own driver
    module, whose classes the test patches."""
    real = harness.load_module
    return lambda path, name: driver if path.parent.name == "drivers" \
        else real(path, name)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_reference_agree(bench, cell):
    """The result object has the contract's keys, the checks last, the
    end-to-end metrics of the cell, and the port's CPU path agrees with
    the reference."""
    res = run_cell(bench, cell)
    assert list(res)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(res)[-1] == "checks"
    json.loads(json.dumps(res))
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(bench, cell, False)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_multicast_reference_forms_agree():
    """The reference's vectorised round against the same predicates
    written one sender at a time, on random arrivals and shapes, with and
    without the stability wait; and its count of messages delivered at
    every member against one made from the delivery log."""
    from reference import smc

    rng = np.random.default_rng(1)
    for _ in range(12):
        s = int(rng.integers(1, 6))
        n, w = s + int(rng.integers(0, 3)), int(rng.integers(1, 9))
        arr = rng.integers(0, 6, (120, s)) * (rng.random((120, s))
                                              < rng.random())
        for stability in (True, False):
            got = smc.simulate(arr, n, w, stability=stability)
            want = plain_simulate(arr, n, w, stability=stability)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        batch, pub, nulls, _ = got
        flags = [np.repeat(np.tile([True, False], len(pub)),
                           np.stack([pub[:, r], nulls[:, r]], 1).ravel())
                 for r in range(s)]
        seqs = np.cumsum(batch, 0).min(1)
        by_log = [sum(int(flags[r][:smc.own_count(int(d), r, s)].sum())
                      for r in range(s)) for d in seqs]
        assert np.array_equal(smc.apps_everywhere(batch, pub, nulls), by_log)


def plain_simulate(arrivals, n, window, *, stability=True):
    """The reference's round with each sender's predicates in a loop."""
    from reference import smc

    t_n, s = arrivals.shape
    published, backlog = np.zeros(s, np.int64), np.zeros(s, np.int64)
    pub_vis, recv = np.zeros((n, s), np.int64), np.zeros((n, s), np.int64)
    received, delivered = np.full(n, -1), np.full(n, -1)
    recv_vis, deliv_vis = np.full((n, n), -1), np.full((n, n), -1)
    out = [np.zeros((t_n, n), np.int64), np.zeros((t_n, s), np.int64),
           np.zeros((t_n, s), np.int64)]
    for t in range(t_n):
        want = backlog + arrivals[t]
        recv = np.maximum(recv, pub_vis)
        received = np.maximum(received, smc.rr_prefix(recv) - 1)
        for i in range(s):
            target = 0
            for j in range(s):
                if j != i and recv[i, j] > 0:
                    target = max(target, recv[i, j] - 1 + (i < j))
            if want[i] == 0:
                out[2][t, i] = max(target - published[i], 0)
            seen = deliv_vis[i].copy()
            seen[i] = delivered[i]
            cap = smc.own_count(int(seen.min()) + 1, i, s) + window
            out[1][t, i] = min(want[i], max(cap - published[i], 0))
        published = published + out[1][t] + out[2][t]
        for i in range(s):
            recv[i, i] = max(recv[i, i], published[i])
        received = np.maximum(received, smc.rr_prefix(recv) - 1)
        seen = recv_vis.copy()
        np.fill_diagonal(seen, received)
        new = np.maximum(delivered, seen.min(axis=1) if stability
                         else received)
        out[0][t] = new - delivered
        delivered = new
        pub_vis = np.maximum(pub_vis, published[None, :])
        recv_vis = np.maximum(seen, received[None, :])
        deliv_vis = np.maximum(deliv_vis, delivered[None, :])
        backlog = want - out[1][t]
    return (*out, backlog)


def test_multicast_control_and_faults(bench, monkeypatch):
    """The control (delivery without the stability wait) fails where the
    program passes; a run whose rounds leave the state unchanged, one
    checked against half of each round's arrivals, and one whose
    delivered count is altered where the device wrote it each come out
    not correct."""
    driver, config, traffic, ctx = runner_of(bench, "tiny.saturate")
    ctx.seconds = 0.3
    rows = driver.control_readings(config, traffic, ctx, [3, 4, 5])
    for row in rows:
        assert all(v == 0 for v in row["program"].values())
        assert row["control"]["delivery_mismatches"] > 0
    from repro_torch.core import sweep

    real_round = sweep.stream_stacked

    def unchanged(states, backlogs, ready, **kw):
        _, traces = real_round(states, backlogs, ready, **kw)
        return (states, backlogs), traces
    real_traces = driver.StreamFused.traces

    def half(self):
        tr = real_traces(self)
        tr["arrivals"][:, ::2] //= 2
        return tr

    def altered(self):
        tr = real_traces(self)
        tr["batch"][-1, 0] += 1
        return tr
    for where, name, fn in ((sweep, "stream_stacked", unchanged),
                            (driver.StreamFused, "traces", half),
                            (driver.StreamFused, "traces", altered)):
        with monkeypatch.context() as m:
            m.setattr(where, name, fn)
            m.setattr(harness, "load_module", same_driver(driver))
            assert run_cell(bench, "tiny.saturate")["correct"] is False


def test_serve_control_and_faults(bench, monkeypatch):
    """Served tokens are the reference's greedy tokens at the tiny size
    (the float8 control is read here and held to the limit at the cell's
    size by the chip test); a run with an altered token and one whose
    decode leaves the cache unchanged come out not correct."""
    driver, config, traffic, ctx = runner_of(bench, "tiny.decode")
    rows = driver.control_readings(config, traffic, ctx, [3, 4, 5])
    assert max(r["logit_gap"] for r in rows) <= traffic["gap_limit"] / 10
    assert all(r["control_fp8"] >= 0 for r in rows)
    from repro_torch.models import transformer

    real_step = transformer.decode_step

    def stale(params, cfg, cache, tokens, pos, rt, valid=None):
        copy = {k: v.clone() for k, v in cache.items()}
        return real_step(params, cfg, copy, tokens, pos, rt, valid)[0], cache
    real_call = driver.ServeFused.call

    def altered(self):
        real_call(self)
        _, got = max(self.served, key=lambda pg: pg[1].size)
        got[-1] = (got[-1] + 1) % self.cfg.vocab_size
    for where, name, fn in ((transformer, "decode_step", stale),
                            (driver.ServeFused, "call", altered)):
        with monkeypatch.context() as m:
            m.setattr(where, name, fn)
            m.setattr(harness, "load_module", same_driver(driver))
            assert run_cell(bench, "tiny.decode")["correct"] is False


def test_train_control_and_faults(bench, monkeypatch):
    """The three readings of sound steps are small and the float8
    control reads more than three times as much on one of them; a run
    whose step leaves the state unchanged and one whose step takes half
    the batch come out not correct."""
    driver, config, traffic, ctx = runner_of(bench, "tiny.train")
    rows = driver.control_readings(config, traffic, ctx, [3, 4, 5])
    low = {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}
    assert all(low[k] <= traffic["limits"][k] / 4 for k in low)
    assert any(min(r["control_fp8"][k] for r in rows) > 3 * low[k]
               for k in low)
    from repro_torch.optim import adamw

    def frozen(cfg, grads, state, param_dtype=torch.bfloat16, *,
               params=None, grad_norm=None):
        new = dict(state, step=state["step"] + 1)
        return params, new, {"grad_norm": adamw.global_norm(grads),
                             "lr": adamw.schedule(cfg, new["step"])}
    real_call = driver.Train.call

    def half(self):
        batch = self.batch
        self.batch = lambda step: batch(step)[:1]
        try:
            real_call(self)
        finally:
            del self.batch
    for where, name, fn in ((adamw, "update", frozen),
                            (driver.Train, "call", half)):
        with monkeypatch.context() as m:
            m.setattr(where, name, fn)
            m.setattr(harness, "load_module", same_driver(driver))
            assert run_cell(bench, "tiny.train")["correct"] is False


def test_no_jax_in_a_run(bench, tmp_path):
    """A run of every tiny cell in a fresh process loads no module whose
    top-level name, taken whole, is jax, jaxlib, flax or repro."""
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, time; sys.path.insert(0, %r);"
        "import harness; harness.prepare_environment();"
        "b = json.load(open(%r));"
        "[harness.execute(c, 5, 0.2, False, time.perf_counter(),"
        " device='cpu', bench=b) for c in %r];"
        "print(json.dumps(harness.forbidden_modules()));"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % (str(harness.BENCH), str(tmp_path / "bench.json"), list(CELLS)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    bad, tops = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert bad == []
    assert "repro_torch" in tops and "torch" in tops
