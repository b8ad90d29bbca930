"""The controls at each cell's own size, on the card: on three seeds the
program's compared numbers stay within their limits and the control
fails one of them.  ``python -m pytest -q -m chip spindle_bench/tests``
on a machine with a card; each test skips without one."""

from types import SimpleNamespace

import pytest
import torch

import harness

SEEDS = (1009, 2003, 3001)


def readings(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, config, traffic = harness.cell_spec(bench, cell)
    driver = harness.load_module(
        harness.BENCH / "drivers" / f"{traffic['driver']}.py",
        f"chip_driver_{traffic['driver']}")
    ctx = SimpleNamespace(seed=SEEDS[0], device="cuda", log=harness.log,
                          seconds=bench["run_seconds"])
    return traffic, driver.control_readings(config, traffic, ctx, SEEDS)


@pytest.mark.chip
def test_multicast_control_fails():
    _, rows = readings("testbed16.saturate")
    for r in rows:
        assert all(v == 0 for v in r["program"].values())
        assert r["control"]["delivery_mismatches"] > 0


@pytest.mark.chip
def test_serve_control_fails():
    traffic, rows = readings("qwen3_1_7b.serve_decode_heavy")
    for r in rows:
        assert r["logit_gap"] <= traffic["gap_limit"] < r["control_fp8"]


@pytest.mark.chip
def test_train_control_fails():
    traffic, rows = readings("qwen3_1_7b.train_1card")
    lim = traffic["limits"]
    for r in rows:
        assert all(r["program"][k] <= lim[k] for k in lim)
        assert any(r["control_fp8"][k] > lim[k] for k in lim)
