"""``BENCHMARK.json`` against the rules the harness relies on, the
yardstick's counts against counts by hand, and a configuration, a mix
and a metric added as new files alone."""

import json
import re
import shutil
import subprocess
import sys

import numpy as np

import harness
from tiny import tiny_bench
from yardstick import flops
from yardstick import traffic as gen

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_follows_the_rules():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["spindle_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"] != "setup_s":
            assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
    for cell in bench["workloads"]:
        assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
        assert cell["chips"] in (1, 4)
        _, config, traffic = harness.cell_spec(bench, cell["name"])
        assert (harness.BENCH / "drivers" /
                f"{traffic['driver']}.py").exists()
        got = {m["name"] for m in harness.metrics_of(bench, cell["name"],
                                                     False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.metrics_of(bench, cell["name"], True)
    for c in bench["configs"]:
        assert c["file"].startswith("spindle_bench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]


def test_flop_and_byte_counts_by_hand():
    """One shape of each formula, counted term by term."""
    cfg = {"num_hidden_layers": 2, "hidden_size": 8,
           "intermediate_size": 16, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 2, "vocab_size": 10}
    # q, k, v, o: 8x8, 8x4, 8x4, 8x8; gate, up, down: 3 x 8x16; head 8x10
    per_layer = 64 + 32 + 32 + 64 + 3 * 128
    assert flops.matmul_params(cfg) == 2 * per_layer + 80
    # prompt 3, 2 outputs: steps at positions 0..3, keys 1+2+3+4
    assert flops.decoder_tokens(cfg, 3, 2) == \
        2 * (2 * per_layer + 80) * 4 + 4 * 2 * 4 * 2 * 10
    nbytes, f = flops.flash_decode(cfg, 3, 2)
    assert nbytes == 2 * 2 * (2 * 2 * 2 * 10 + 2 * 4 * 2 * 4)
    assert f == 4 * 2 * 4 * 2 * 10
    # batch 1, 3 positions: causal pairs 6, both products, 4 heads of 2
    assert flops.flash_attention(cfg, 1, 3, False) == \
        (2 * 3 * 4 * 2 * 2 + 2 * 3 * 2 * 2 * 2, 4 * 4 * 2 * 6)
    assert flops.train_step(cfg, 1, 3) == \
        6 * (2 * per_layer + 80) * 3 + 3 * 4 * 2 * 4 * 2 * 6
    assert flops.roofline_seconds(3.35e12, 0, 1.0) == 1.0


def test_traffic_is_fixed_work_in_seeded_order():
    sat = harness.load_json(harness.BENCH / "traffic/saturate.json")
    a = gen.stream_arrivals(sat, 2 ** 40 + 3, 0, 16)
    b = gen.stream_arrivals(sat, 2 ** 40 + 3, 0, 16)
    c = gen.stream_arrivals(sat, 5, 1, 16)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(np.sort(a, axis=0), np.sort(c, axis=0))
    dec = harness.load_json(harness.BENCH / "traffic/decode_heavy.json")
    x = gen.serve_batch(dec, 11, 0, 1000)
    y = gen.serve_batch(dec, 12, 3, 1000)
    z = gen.serve_batch(dec, 12, 0, 1000)
    for gx, gy, gz in zip(x, y, z):
        assert sorted(len(p) for p, _ in gx) == sorted(len(p) for p, _ in gy)
        assert sorted(o for _, o in gx) == sorted(o for _, o in gy)
        # the same call of another seed: the same lengths in the same
        # order, other token ids
        assert [(len(p), o) for p, o in gx] == [(len(p), o) for p, o in gz]
        assert any((p != q).any() for (p, _), (q, _) in zip(gx, gz))
    outs = gen.lognormal_lengths(32, 192, 0.6, 32, 512)
    assert outs.min() >= 32 and outs.max() == 512
    assert abs(np.median(outs) - 192) <= 8


def test_new_config_mix_and_metric_are_found(tmp_path):
    """A copy of the folder gains a configuration, a mix and a metric as
    new files; a run finds them by name with no other file edited."""
    copy = tmp_path / "spindle_bench"
    shutil.copytree(harness.BENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tiny_bench(tmp_path)
    group = json.loads((tmp_path / "tiny_group.json").read_text())
    group.update(n_nodes=3, n_senders=3)
    (copy / "configs" / "trio.json").write_text(json.dumps(group))
    mix = json.loads((tmp_path / "tiny_saturate.json").read_text())
    mix.update(per_sender_per_round=[1, 5])
    (copy / "traffic" / "lumpy.json").write_text(json.dumps(mix))
    (copy / "metrics" / "mcast_calls.py").write_text(
        "def read(run):\n    return run.calls\n")
    bench["configs"].append({"name": "trio", "source": "test",
                             "file": str(copy / "configs" / "trio.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "trio.lumpy", "config": "trio",
                               "traffic": "lumpy", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "mcast_calls", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["trio.lumpy"]})
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    code = ("import sys, json, time; sys.path[:0] = [%r, %r];"
            "import harness; harness.prepare_environment();"
            "b = json.load(open(%r));"
            "print(json.dumps(harness.execute('trio.lumpy', 3, 0.2, False,"
            " time.perf_counter(), device='cpu', bench=b)))"
            % (str(copy), str(harness.ROOT / "src"),
               str(tmp_path / "bench.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["mcast_calls"]["value"] >= 1
    assert set(res["metrics"]) == {"mcast_calls", "setup_s"}
