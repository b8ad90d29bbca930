"""Tiny shapes of the benchmark's cells for the CPU: a BENCHMARK object
whose cells run the real drivers on a two-layer model of width 64 and a
four-node group, written into a scratch folder."""

import copy
import json
from pathlib import Path

import harness

TINY_MODEL = dict(num_hidden_layers=2, hidden_size=64,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  intermediate_size=128, vocab_size=256,
                  initializer_range=0.1,
                  torch_dtype="float32")


def tiny_bench(tmp: Path):
    """(bench object, traffic folder) with the cells ``tiny.saturate``,
    ``tiny.decode`` and ``tiny.train``: the committed configurations and
    mixes cut down, each under its own file in ``tmp``."""
    bench = copy.deepcopy(harness.load_json(harness.ROOT /
                                            "BENCHMARK.json"))
    model = harness.load_json(harness.BENCH / "configs/qwen3_1_7b.json")
    model.update(TINY_MODEL)
    group = harness.load_json(harness.BENCH / "configs/testbed16.json")
    group.update(n_nodes=4, n_senders=4, window=8)
    sat = harness.load_json(harness.BENCH / "traffic/saturate.json")
    sat.update(rounds=40, per_sender_per_round=[0, 0, 1, 3])
    dec = harness.load_json(harness.BENCH / "traffic/decode_heavy.json")
    dec.update(slots=4, max_len=64, requests_per_replica=6,
               output_len={"median": 12, "sigma": 0.6, "min": 4,
                           "max": 24}, check_tokens=60, gap_limit=1e-3)
    trn = harness.load_json(harness.BENCH / "traffic/train_2x2048.json")
    trn.update(seq_len=32)
    for name, obj in (("tiny_model", model), ("tiny_group", group),
                      ("tiny_saturate", sat), ("tiny_decode", dec),
                      ("tiny_train", trn)):
        (tmp / f"{name}.json").write_text(json.dumps(obj))
    bench["configs"] += [
        {"name": "tiny_model", "source": "test", "reduced": [],
         "file": str(tmp / "tiny_model.json"), "why": "test"},
        {"name": "tiny_group", "source": "test", "reduced": [],
         "file": str(tmp / "tiny_group.json"), "why": "test"}]
    bench["workloads"] += [
        {"name": "tiny.saturate", "config": "tiny_group",
         "traffic": str(tmp / "tiny_saturate"), "chips": 1, "why": "test"},
        {"name": "tiny.decode", "config": "tiny_model",
         "traffic": str(tmp / "tiny_decode"), "chips": 1, "why": "test"},
        {"name": "tiny.train", "config": "tiny_model",
         "traffic": str(tmp / "tiny_train"), "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            real = next(w["name"].split(".")[1] for w in bench["workloads"]
                        if w["name"] in m["workloads"])
            m["workloads"] = m["workloads"] + [
                {"saturate": "tiny.saturate",
                 "serve_decode_heavy": "tiny.decode",
                 "train_1card": "tiny.train"}[real]]
    return bench
