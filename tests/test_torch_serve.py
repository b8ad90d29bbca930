"""The port's serve plane (``ServeEngine`` + ``ReplicatedEngine.run``)
against the reference's, in float32 on the CPU.

The reference's parameters (``jax.random.key(0)``, the FAN shape of
``tests/test_serve_fanout.py``) are cast to float32 and carried across
with ``params_from_numpy``; the reference engine runs with
``repro.models.layers.DEFAULT_DTYPE`` patched to float32 and its cache
cast to float32.  Port ``"graph"`` runs against reference ``"graph"``,
port ``"kernel"`` against reference ``"pallas"``.  Tokens, per-topic
delivery logs, integer report fields, the serve counters and the
admit / finish / free round traces must be exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.load.admission import ServeAdmission as RefServeAdmission
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import engine as ref_engine
from repro.serve.fanout import ReplicatedEngine as RefReplicatedEngine
from repro_torch import api
from repro_torch.models import convert, registry
from repro_torch.models.config import ModelConfig

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

FAN_ARGS = dict(name="fanout-test", family="dense", n_layers=2,
                d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                vocab_size=512, head_dim=32, tie_embeddings=True)
REF_FAN, FAN = RefModelConfig(**FAN_ARGS), ModelConfig(**FAN_ARGS)
ref_registry.register("fanout-test", lambda: REF_FAN)
registry.register("fanout-test", lambda: FAN)

N_REPLICAS, N_SLOTS, NEW_TOKENS, MAX_LEN = 2, 2, 4, 48
BACKENDS = [("graph", "graph"), ("kernel", "pallas")]
INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled")
SERVE_KEYS = ("replicas", "engine_rounds", "drained", "decode_steps",
              "requests", "tokens", "stall_rounds", "held_slots",
              "view_changes", "slot_failures", "voided_requests",
              "requeued_requests", "slot_failure_log", "fail_at_unreached",
              "shed_requests", "max_queue_depth", "max_backlog", "fused",
              "host_hops")
TRACES = ("admit_rounds", "admit_slots", "finish_rounds", "free_rounds",
          "submit_rounds", "finish_round_by_rid", "shed_log",
          "queue_depth_log", "backlog_log", "stall_rounds")


@pytest.fixture(scope="module")
def params():
    tree = ref_layers.init_tree(ref_registry.param_specs(REF_FAN),
                                jax.random.key(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def ref_engines(params):
    engines = []
    for _ in range(N_REPLICAS):
        eng = ref_engine.ServeEngine(
            "fanout-test", jax.tree.map(jnp.asarray, params), REF_FAN,
            ref_engine.EngineConfig(max_batch=N_SLOTS, max_len=MAX_LEN),
            RefRuntime())
        eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32), eng.cache)
        engines.append(eng)
    return engines


@pytest.fixture(scope="module")
def port_engines(params):
    p = convert.params_from_numpy(params, FAN, "cpu", torch.float32)
    return [api.ServeEngine("fanout-test", p, FAN,
                            api.EngineConfig(max_batch=N_SLOTS,
                                             max_len=MAX_LEN),
                            device="cpu")
            for _ in range(N_REPLICAS)]


def _requests(request_cls, n_per_replica, seed, rid0=0):
    rng = np.random.default_rng(seed)
    return [[request_cls(rid=rid0 + g * 100 + i,
                         prompt=rng.integers(0, FAN.vocab_size,
                                             int(rng.integers(1, 6)),
                                             dtype=np.int32),
                         max_new_tokens=NEW_TOKENS)
             for i in range(n_per_replica)] for g in range(N_REPLICAS)]


def _stall(g, rnd):
    return (0,) if (g == 0 and 2 <= rnd < 5) else ()


def _stall_array():
    arr = np.zeros((12, N_REPLICAS, N_SLOTS), bool)
    arr[1:4, 1, 1] = True
    arr[6, 0, :] = True
    return arr


def _assert_logs_equal(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.n_senders == w.n_senders
        assert g.delivered_seq == w.delivered_seq, name
        for x, y in zip(g.is_app, w.is_app, strict=True):
            np.testing.assert_array_equal(x, y, err_msg=name)


def _assert_runs_equal(port_rep, ref_rep, got, want):
    assert port_rep.completed() == ref_rep.completed()
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.duration_us, want.duration_us,
                               rtol=1e-6)
    _assert_logs_equal(got.extras["delivery_logs"],
                       want.extras["delivery_logs"])
    assert got.extras["streamed_rounds"] == want.extras["streamed_rounds"]
    for key in SERVE_KEYS:
        assert got.extras["serve"][key] == want.extras["serve"][key], key
    assert set(got.extras["serve"]) == set(want.extras["serve"]) - \
        {"fused_fallback"}
    for name in TRACES:
        assert getattr(port_rep, name) == getattr(ref_rep, name), name


def _run_both(monkeypatch, port_engines, ref_engines, port_backend,
              ref_backend, scenario):
    """Run one scenario on both packages; returns both reports."""
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    out = []
    for pkg, engines, backend in (("port", port_engines, port_backend),
                                  ("ref", ref_engines, ref_backend)):
        rep_cls = api.ReplicatedEngine if pkg == "port" \
            else RefReplicatedEngine
        kw = dict(scenario.get("rep_kw", {}), backend=backend)
        if pkg == "port":
            kw["device"] = "cpu"
        rep = rep_cls(engines, subscribers_per_replica=2, **kw)
        rep.reset()
        req_cls = api.Request if pkg == "port" else ref_engine.Request
        run_kw = dict(scenario.get("run_kw", {}))
        if "admission" in run_kw:
            cls = api.ServeAdmission if pkg == "port" else RefServeAdmission
            run_kw["admission"] = cls(**run_kw["admission"])
        if scenario.get("arrivals"):
            waves = _requests(req_cls, scenario["n_reqs"], seed=5)
            sched = [[[] for _ in range(N_REPLICAS)] for _ in range(4)]
            for g, reqs in enumerate(waves):
                for i, req in enumerate(reqs):
                    sched[i % 4][g].append(req)
            run_kw["arrive_schedule"] = sched
        else:
            for g, reqs in enumerate(_requests(req_cls, scenario["n_reqs"],
                                               seed=0)):
                for req in reqs:
                    rep.submit(g, req)
        report = rep.run(**run_kw)
        out.append((rep, report))
        if "second_run" in scenario:
            for g, reqs in enumerate(_requests(req_cls, 1, seed=9,
                                               rid0=1000)):
                for req in reqs:
                    rep.submit(g, req)
            out.append((rep, rep.run(**scenario["second_run"])))
    half = len(out) // 2
    for (port_rep, got), (ref_rep, want) in zip(out[:half], out[half:]):
        _assert_runs_equal(port_rep, ref_rep, got, want)
    return [r for _, r in out]


SCENARIOS = {
    # test_serve_fanout's conformance run: a stalled client for 3 rounds
    "stall_fn": dict(n_reqs=3, rep_kw=dict(window=4, stall_fn=_stall)),
    # the stall schedule as a (rounds, G, slots) array
    "stall_array": dict(n_reqs=3,
                        rep_kw=dict(window=4, stall_fn=_stall_array())),
    # open-loop arrivals into a capped queue with watermark stalls
    "admission": dict(n_reqs=5, arrivals=True, rep_kw=dict(window=3),
                      run_kw=dict(admission=dict(queue_cap=2,
                                                 stall_backlog=3))),
    # the tiny-window hold release, then a cut-short second run
    "tiny_window": dict(n_reqs=4, rep_kw=dict(window=2),
                        second_run=dict(max_rounds=2)),
}


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_replicated_engine_matches_the_reference(
        monkeypatch, port_engines, ref_engines, port_backend, ref_backend,
        scenario):
    reports = _run_both(monkeypatch, port_engines, ref_engines,
                        port_backend, ref_backend, SCENARIOS[scenario])
    serve = reports[0].extras["serve"]
    assert serve["tokens"] > 0 and serve["decode_steps"] > 0
    if scenario == "stall_fn":
        assert serve["drained"] and serve["stall_rounds"] == 3
        assert reports[0].nulls_sent > 0
    if scenario == "admission":
        assert serve["shed_requests"] > 0
    if scenario == "tiny_window":
        assert serve["held_slots"] == 0
        assert not reports[1].extras["serve"]["drained"]
        assert reports[1].extras["serve"]["tokens"] == 0


def test_unported_options_raise(port_engines):
    rep = api.ReplicatedEngine(port_engines, device="cpu")
    # fail_at crosses the cut now (tests/test_torch_serve_cut.py): node 0,
    # replica 0's first slot, dies after round 1; its request restarts
    rep.reset()
    for g, reqs in enumerate(_requests(api.Request, 2, seed=0)):
        for req in reqs:
            rep.submit(g, req)
    serve = rep.run(fail_at={1: [0]}).extras["serve"]
    assert serve["drained"] and serve["view_changes"] == 1
    assert serve["slot_failures"] == 1 and serve["requests"] == 4
    done = rep.completed()
    # fused=True is ported (tests/test_torch_serve_fused.py): this cut
    # leaves the replicas unequal, so the run falls back to the per-round
    # loop and says so, with the same results
    rep.reset()
    for g, reqs in enumerate(_requests(api.Request, 2, seed=0)):
        for req in reqs:
            rep.submit(g, req)
    fused = rep.run(fail_at={1: [0]}, fused=True).extras["serve"]
    assert fused["fused"] is False
    assert fused["fused_fallback"].startswith(
        "fail_at cut at round 1 leaves heterogeneous replicas")
    assert rep.completed() == done
    assert {k: fused[k] for k in SERVE_KEYS if k != "host_hops"} == \
        {k: serve[k] for k in SERVE_KEYS if k != "host_hops"}
    # ... and without the cut it takes the fused path, equal to the loop
    rep.reset()
    for g, reqs in enumerate(_requests(api.Request, 2, seed=0)):
        for req in reqs:
            rep.submit(g, req)
    loop = rep.run().extras["serve"]
    done = rep.completed()
    rep.reset()
    for g, reqs in enumerate(_requests(api.Request, 2, seed=0)):
        for req in reqs:
            rep.submit(g, req)
    fused = rep.run(fused=True).extras["serve"]
    assert fused["fused"] is True and fused["host_hops"] == 0
    assert rep.completed() == done
    assert {k: fused[k] for k in SERVE_KEYS if k not in ("fused",
                                                         "host_hops")} == \
        {k: loop[k] for k in SERVE_KEYS if k not in ("fused", "host_hops")}


def test_entry_points_want_the_gpu_unless_told(params, port_engines):
    p = convert.params_from_numpy(params, FAN, "cpu", torch.float32)
    ecfg = api.EngineConfig(max_batch=N_SLOTS, max_len=MAX_LEN)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.ServeEngine("fanout-test", p, FAN, ecfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            api.ReplicatedEngine(port_engines)
    with pytest.raises(ValueError, match="params are on"):
        api.ServeEngine("fanout-test", p, FAN, ecfg, device="meta")


def test_engine_counts_steps_and_syncs(port_engines):
    eng = port_engines[0]
    eng.reset()
    eng.submit(api.Request(rid=1, prompt=np.arange(3, dtype=np.int32),
                           max_new_tokens=2))
    done = eng.run_until_drained()
    assert [r.rid for r in done] == [1] and len(done[0].tokens_out) == 2
    # 3 prompt tokens prefilled one step each, then 2 decode steps; the
    # token ids cross to the host once per decode step
    assert eng.decode_steps == 5 and eng.host_syncs == 2
    assert eng.rounds == 2 and eng.drained()
    eng.submit(api.Request(rid=2, prompt=np.arange(2, dtype=np.int32)))
    eng.step()
    assert eng.evict(0) is not None and eng.slot_req[0] is None
    eng.reset()
