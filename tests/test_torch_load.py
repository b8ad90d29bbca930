"""The port's workload plane (``repro_torch.load``) against the
reference's, on the CPU.

``tests/test_load.py``'s cases but the DES conformance one (the DES is
not ported): seeded arrivals and profiles drawing the reference's
matrices, the harness on ``graph`` and ``kernel`` giving byte-identical
``LoadReport``s (and the reference's JSON, byte for byte), honest
saturation under the bounding policies, the serve-plane lowering, the
bounded program history, and ``fused=True`` — the profile's rounds and
the drain chunks as device round programs
(``repro_torch.core.graphloop``), their reports byte-equal to the host
loop's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import load as ref_load
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import engine as ref_engine
from repro.serve.fanout import ReplicatedEngine as RefReplicatedEngine
from repro_torch import api
from repro_torch import load
from repro_torch.core import group as group_mod
from repro_torch.load import (AdmitAll, Diurnal, OnOff, Poisson, Profile,
                              ServeAdmission, Stage, TokenBucket, Trace,
                              WindowSlack, run_profile, staged_ramp)
from repro_torch.models import convert, registry
from repro_torch.models.config import ModelConfig

pytestmark = pytest.mark.fast

BACKENDS = [("graph", "graph"), ("kernel", "pallas")]


def _profile(pkg=load, seed=0, overload=5.0, rate=0.5, rounds=20):
    return pkg.staged_ramp(pkg.Poisson(rate=rate), warmup=10, steps=(1.0,),
                           rounds_per_stage=rounds, overload=overload,
                           overload_rounds=rounds, seed=seed)


def _small_profile(pkg=load, seed=0):
    return pkg.staged_ramp(pkg.Poisson(rate=0.5), warmup=6, steps=(1.0,),
                           rounds_per_stage=8, overload=4.0,
                           overload_rounds=8, seed=seed)


def _group(pkg=api, n=4, senders=2, window=4):
    cfg = pkg.single_group(n, n_senders=senders, msg_size=4096,
                           window=window, n_messages=0)
    return pkg.Group(cfg, device="cpu") if pkg is api else pkg.Group(cfg)


def _policy(pkg, name):
    return {"admit-all": lambda: pkg.AdmitAll(),
            "window-slack": lambda: pkg.WindowSlack(queue_cap=8),
            "token-bucket": lambda: pkg.TokenBucket(rate=0.7, burst=4.0,
                                                    queue_cap=8)}[name]()


# ---------------------------------------------------------------------------
# arrivals + profiles: seeded determinism, the reference's draws
# ---------------------------------------------------------------------------

SPECS = {"poisson": dict(cls="Poisson", kw=dict(rate=0.7)),
         "onoff": dict(cls="OnOff", kw=dict(rate_on=2.0, p_on_off=0.2,
                                            p_off_on=0.3)),
         "diurnal": dict(cls="Diurnal", kw=dict(rate=1.0, period=30)),
         "trace": dict(cls="Trace", kw=dict(counts=[0, 2, 1, 3]))}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_same_seed_bit_identical_arrivals(spec):
    mk = {pkg: getattr(pkg, SPECS[spec]["cls"])(**SPECS[spec]["kw"])
          for pkg in (load, ref_load)}
    p = Profile(arrivals=mk[load], seed=7, stages=(
        Stage("a", 12, 0.5), Stage("b", 9, 2.0)))
    m1 = p.matrices((2, 3))
    m2 = p.matrices((2, 3))
    assert len(m1) == len(m2) == 2
    for a, b in zip(m1, m2):
        np.testing.assert_array_equal(a, b)
    m3 = Profile(arrivals=mk[load], seed=8, stages=p.stages).matrices(
        (2, 3))
    assert any(not np.array_equal(a, b) for a, b in zip(m1, m3))
    ref = ref_load.Profile(arrivals=mk[ref_load], seed=7, stages=(
        ref_load.Stage("a", 12, 0.5), ref_load.Stage("b", 9, 2.0)))
    for a, b in zip(m1, ref.matrices((2, 3))):
        np.testing.assert_array_equal(a, b)


def test_sender_mask_zeroes_padded_lanes_only():
    p = Profile(arrivals=Poisson(rate=5.0), seed=1,
                stages=(Stage("s", 10, 1.0),))
    mask = np.array([[True, True, False], [True, False, False]])
    m = p.matrices((2, 3), mask)[0]
    assert (m[:, ~mask] == 0).all()
    assert m[:, mask].sum() > 0
    unmasked = p.matrices((2, 3))[0]
    np.testing.assert_array_equal(m[:, mask], unmasked[:, mask])


def test_diurnal_phase_continues_across_stages():
    spec = Diurnal(rate=3.0, period=16, amplitude=1.0)
    split = Profile(arrivals=spec, seed=5, stages=(
        Stage("a", 8, 1.0), Stage("b", 8, 1.0)))
    whole = Profile(arrivals=spec, seed=5, stages=(Stage("w", 16, 1.0),))
    np.testing.assert_array_equal(
        np.concatenate(split.matrices((1, 2)), axis=0),
        whole.matrices((1, 2))[0])


def test_staged_ramp_shape():
    p = staged_ramp(Poisson(rate=1.0), warmup=5, steps=(0.5, 1.0),
                    rounds_per_stage=7, overload=4.0, seed=0)
    assert [s.name for s in p.stages] == \
        ["warmup", "step-0.5", "step-1", "overload"]
    assert p.total_rounds == 5 + 7 + 7 + 7
    assert p.stage_bounds()[-1] == (19, 26)


def test_trace_arrivals_replay_cyclically():
    t = Trace(counts=[0, 2, 1, 3])
    m = Profile(arrivals=t, seed=0, stages=(Stage("s", 8, 1.0),)).matrices(
        (1, 1))[0]
    np.testing.assert_array_equal(m[:, 0, 0], [0, 2, 1, 3, 0, 2, 1, 3])
    assert isinstance(OnOff(rate_on=1.0), load.ArrivalSpec)


# ---------------------------------------------------------------------------
# the harness: determinism, backend conformance, the reference's JSON
# ---------------------------------------------------------------------------

def test_load_report_graph_vs_kernel_identical():
    prof = _profile()
    reports = {be: run_profile(_group(), prof,
                               WindowSlack(inflight_limit=8, queue_cap=16),
                               backend=be) for be in ("graph", "kernel")}
    a = json.dumps(reports["graph"].to_json(), sort_keys=True)
    b = json.dumps(reports["kernel"].to_json(), sort_keys=True)
    assert a == b
    again = run_profile(_group(), prof,
                        WindowSlack(inflight_limit=8, queue_cap=16),
                        backend="graph")
    assert json.dumps(again.to_json(), sort_keys=True) == a


@pytest.mark.parametrize("policy", ["admit-all", "window-slack",
                                    "token-bucket"])
def test_load_report_json_is_the_references(policy):
    """Same profile, same policy: the port's LoadReport JSON is the
    reference's byte for byte (its per-stage latency percentiles and us
    folds included)."""
    got = run_profile(_group(), _profile(overload=6.0),
                      _policy(load, policy), backend="kernel")
    want = ref_load.run_profile(_group(ref_api), _profile(ref_load,
                                                          overload=6.0),
                                _policy(ref_load, policy), backend="graph")
    assert got.json_str() == want.json_str()


def test_overload_sheds_and_bounds_tail():
    cap, senders = 16, 2
    rep = run_profile(_group(senders=senders), _profile(overload=6.0),
                      WindowSlack(inflight_limit=8, queue_cap=cap))
    over = rep.stage("overload")
    assert over.shed > 0
    assert over.goodput_per_round < over.offered_per_round
    assert over.max_queue_depth <= cap * senders
    assert over.p99_rounds <= 3 * (cap + 8) + 10
    assert over.undelivered == 0


def test_admit_all_is_unbounded_baseline():
    prof = _profile(overload=6.0)
    free = run_profile(_group(), prof, AdmitAll())
    ctrl = run_profile(_group(), prof,
                       WindowSlack(inflight_limit=8, queue_cap=16))
    over_f, over_c = free.stage("overload"), ctrl.stage("overload")
    assert over_f.shed == 0
    assert over_f.max_stream_backlog > over_c.max_stream_backlog
    assert over_f.p99_rounds > over_c.p99_rounds
    assert over_f.offered == over_c.offered


def test_token_bucket_caps_release_rate():
    prof = Profile(arrivals=Poisson(rate=3.0), seed=2,
                   stages=(Stage("s", 30, 1.0),))
    rep = run_profile(_group(), prof,
                      TokenBucket(rate=0.5, burst=2.0, queue_cap=4))
    st = rep.stage("s")
    assert st.shed > 0
    assert st.released < st.offered
    assert st.released + st.shed == st.offered
    assert st.p99_rounds <= 3 * (4 + 8) + 10


def test_harness_accounting_balances():
    rep = run_profile(_group(), _profile(overload=6.0),
                      WindowSlack(inflight_limit=8, queue_cap=16))
    t = rep.totals
    assert t["offered"] == (t["released"] + t["shed"]
                            + rep.stages[-1].end_queue_depth)
    assert t["delivered"] + t["undelivered"] == t["released"]


def test_harness_rejects_stale_stream_and_bad_target():
    g = _group()
    stream = g.stream(backend="graph")
    stream.step(np.zeros(stream.shape, np.int32))
    with pytest.raises(ValueError, match="fresh stream"):
        run_profile(stream, _profile())
    with pytest.raises(TypeError, match="cannot load-test"):
        run_profile(object(), _profile())
    with pytest.raises(TypeError, match="ServeAdmission"):
        run_profile(_group(), _profile(), ServeAdmission(queue_cap=4))


def test_bound_domain_target_and_push_matrix():
    d = api.many_topic_domain(4, 3, window=8)
    rep = run_profile(d.bind(backend="graph", device="cpu"),
                      _profile(seed=4, rounds=10, overload=3.0),
                      WindowSlack(inflight_limit=8, queue_cap=8))
    assert rep.totals["delivered"] > 0
    want = ref_load.run_profile(
        ref_api.many_topic_domain(4, 3, window=8).bind(backend="graph"),
        _profile(ref_load, seed=4, rounds=10, overload=3.0),
        ref_load.WindowSlack(inflight_limit=8, queue_cap=8))
    assert rep.json_str() == want.json_str()
    b1 = d.bind(backend="graph", device="cpu")
    b2 = d.bind(backend="graph", device="cpu")
    v1 = b1.push_round({"topic-0": 2})
    ready = np.zeros(b2.stream.shape, np.int32)
    ready[b2.gid_of("topic-0"), 0] = 2
    v2 = b2.push_matrix(ready)
    np.testing.assert_array_equal(v1.published, v2.published)
    assert set(b2.topic_backlogs()) == {"topic-0", "topic-1", "topic-2"}


# ---------------------------------------------------------------------------
# serve-plane lowering: open-loop arrivals into ReplicatedEngine
# ---------------------------------------------------------------------------

LOAD_ARGS = dict(name="load-test", family="dense", n_layers=1, d_model=32,
                 n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                 head_dim=16, tie_embeddings=True)
ref_registry.register("load-test", lambda: RefModelConfig(**LOAD_ARGS))
registry.register("load-test", lambda: ModelConfig(**LOAD_ARGS))


@pytest.fixture(scope="module")
def load_params():
    cfg = RefModelConfig(**LOAD_ARGS)
    tree = ref_layers.init_tree(ref_registry.param_specs(cfg),
                                jax.random.key(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def load_engines(load_params):
    cfg = ModelConfig(**LOAD_ARGS)
    p = convert.params_from_numpy(load_params, cfg, "cpu", torch.float32)
    return [api.ServeEngine("load-test", p, cfg,
                            api.EngineConfig(max_batch=2, max_len=32),
                            device="cpu") for _ in range(2)]


def _replicated(engines, backend="graph"):
    rep = api.ReplicatedEngine(engines, subscribers_per_replica=2, window=4,
                               backend=backend, device="cpu")
    rep.reset()
    return rep


def _ref_replicated(load_params):
    cfg = RefModelConfig(**LOAD_ARGS)
    p = jax.tree.map(jnp.asarray, load_params)
    engines = []
    for _ in range(2):
        eng = ref_engine.ServeEngine("load-test", p, cfg,
                                     ref_engine.EngineConfig(max_batch=2,
                                                             max_len=32),
                                     RefRuntime())
        eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32), eng.cache)
        engines.append(eng)
    return RefReplicatedEngine(engines, subscribers_per_replica=2,
                               window=4, backend="graph")


def test_serve_plane_overload_sheds_and_drains(monkeypatch, load_engines,
                                               load_params):
    rep = _replicated(load_engines)
    prof = Profile(arrivals=Poisson(rate=1.5), seed=11,
                   stages=(Stage("warmup", 4, 0.25),
                           Stage("overload", 12, 1.0)))
    report = run_profile(rep, prof,
                         ServeAdmission(queue_cap=3, stall_backlog=6),
                         max_new_tokens=3, prompt_len=2)
    over = report.stage("overload")
    assert over.shed > 0
    assert over.max_queue_depth <= 3 * 2
    assert over.p99_rounds > 0
    assert report.totals["delivered"] + report.totals["shed"] \
        == report.totals["offered"]
    assert report.totals["undelivered"] == 0
    serve = report.run_report.extras["serve"]
    assert serve["shed_requests"] == report.totals["shed"]
    assert all(eng.drained() for eng in rep.engines)
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_prof = ref_load.Profile(
        arrivals=ref_load.Poisson(rate=1.5), seed=11,
        stages=(ref_load.Stage("warmup", 4, 0.25),
                ref_load.Stage("overload", 12, 1.0)))
    want = ref_load.run_profile(
        _ref_replicated(load_params), ref_prof,
        ref_load.ServeAdmission(queue_cap=3, stall_backlog=6),
        max_new_tokens=3, prompt_len=2)
    assert report.json_str() == want.json_str()


# ---------------------------------------------------------------------------
# the program history: bounded, snapshot/reset helpers
# ---------------------------------------------------------------------------

def test_trace_events_bounded_and_helpers():
    saved = group_mod.trace_snapshot()
    try:
        assert group_mod.TRACE_EVENTS.maxlen == group_mod.TRACE_MAXLEN
        n = group_mod.trace_reset()
        assert n == len(saved) and len(group_mod.TRACE_EVENTS) == 0
        for i in range(group_mod.TRACE_MAXLEN + 50):
            group_mod.TRACE_EVENTS.append(((1, 1, i), (1,), "x"))
        assert len(group_mod.TRACE_EVENTS) == group_mod.TRACE_MAXLEN
        assert group_mod.trace_snapshot()[-1][0][2] == \
            group_mod.TRACE_MAXLEN + 49
        group_mod.trace_reset()
    finally:
        group_mod.TRACE_EVENTS.extend(saved)


@pytest.mark.soak
def test_soak_trace_growth_bounded_across_stages():
    """A long fused open-loop run builds its programs once; a second
    identical run builds none."""
    prof = Profile(arrivals=Diurnal(rate=0.8, period=100), seed=9,
                   stages=(Stage("day-1", 150, 1.0),
                           Stage("day-2", 150, 1.2),
                           Stage("day-3", 150, 0.9)))
    before = len(group_mod.trace_snapshot())
    rep = run_profile(_group(window=8), prof,
                      WindowSlack(inflight_limit=16, queue_cap=32),
                      fused=True)
    assert len(group_mod.trace_snapshot()) - before <= 1
    assert len(group_mod.TRACE_EVENTS) <= group_mod.TRACE_MAXLEN
    assert rep.totals["delivered"] > 0
    before = len(group_mod.trace_snapshot())
    again = run_profile(_group(window=8), prof,
                        WindowSlack(inflight_limit=16, queue_cap=32),
                        fused=True)
    assert len(group_mod.trace_snapshot()) == before
    assert again.json_str() == rep.json_str()


# ---------------------------------------------------------------------------
# fused profile runs: byte-identical LoadReports off the device programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["graph", "kernel"])
@pytest.mark.parametrize("policy", ["admit-all", "window-slack",
                                    "token-bucket"])
def test_fused_profile_loadreport_bit_identical(backend, policy):
    ru = run_profile(_group(), _small_profile(), _policy(load, policy),
                     backend=backend)
    rf = run_profile(_group(), _small_profile(), _policy(load, policy),
                     backend=backend, fused=True)
    lf = rf.run_report.extras.get("load_fused")
    assert lf, "profile did not take the fused path"
    assert lf["profile_rounds"] == _small_profile().total_rounds
    assert ru.json_str() == rf.json_str()


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_fused_profile_matches_the_reference_fused_run(backend,
                                                       ref_backend):
    """Profile rounds, a drain chunk and the token bucket's float32
    state: the port's fused report and ``load_fused`` record are the
    reference's."""
    got = run_profile(_group(), _small_profile(),
                      _policy(load, "token-bucket"), backend=backend,
                      fused=True)
    want = ref_load.run_profile(_group(ref_api), _small_profile(ref_load),
                                _policy(ref_load, "token-bucket"),
                                backend=ref_backend, fused=True)
    assert got.json_str() == want.json_str()
    assert got.run_report.extras["load_fused"] == \
        want.run_report.extras["load_fused"]
    assert got.run_report.extras["load_fused"]["drain_rounds"] > 0


def test_fused_profile_bursty_arrivals_bit_identical():
    prof = staged_ramp(OnOff(rate_on=2.5, p_on_off=0.2, p_off_on=0.3),
                       warmup=6, steps=(1.0,), rounds_per_stage=8,
                       overload=3.0, overload_rounds=8, seed=4)
    ru = run_profile(_group(), prof, WindowSlack(queue_cap=6))
    rf = run_profile(_group(), prof, WindowSlack(queue_cap=6), fused=True)
    assert rf.run_report.extras.get("load_fused")
    assert ru.json_str() == rf.json_str()


def test_fused_profile_on_a_padded_domain():
    """A heterogeneous (masked) stack runs fused too: the masks are the
    stream's own."""
    mk = lambda: api.many_topic_domain(4, 3, window=8)  # noqa: E731
    ru = run_profile(mk().bind(backend="kernel", device="cpu"),
                     _profile(seed=4, rounds=10, overload=3.0),
                     WindowSlack(inflight_limit=8, queue_cap=8))
    rf = run_profile(mk().bind(backend="kernel", device="cpu"),
                     _profile(seed=4, rounds=10, overload=3.0),
                     WindowSlack(inflight_limit=8, queue_cap=8), fused=True)
    assert rf.run_report.extras.get("load_fused")
    assert ru.json_str() == rf.json_str()


def test_fused_profile_token_bucket_state_carries_like_host():
    pu = TokenBucket(rate=0.6, burst=3.0, queue_cap=8)
    pf = TokenBucket(rate=0.6, burst=3.0, queue_cap=8)
    run_profile(_group(), _small_profile(), pu)
    run_profile(_group(), _small_profile(), pf, fused=True)
    assert pu._tokens is not None and pf._tokens is not None
    assert pu._tokens.dtype == pf._tokens.dtype == np.float32
    np.testing.assert_array_equal(pu._tokens, pf._tokens)


def test_fused_profile_falls_back_silently():
    """A policy with no device lowering keeps the host loop — same
    report, no load_fused marker."""
    class HostOnly(AdmitAll):
        def fused_key(self):
            return None

    r1 = run_profile(_group(), _small_profile(), HostOnly(), fused=True)
    r2 = run_profile(_group(), _small_profile(), HostOnly())
    assert "load_fused" not in r1.run_report.extras
    assert r1.json_str() == r2.json_str()


def test_serve_target_fused_loadreport_bit_identical(load_engines):
    prof = Profile(arrivals=Poisson(rate=0.4), seed=9,
                   stages=(Stage("warm", 6, 0.5), Stage("load", 8, 2.0)))
    ru = run_profile(_replicated(load_engines), prof,
                     ServeAdmission(queue_cap=3))
    rf = run_profile(_replicated(load_engines), prof,
                     ServeAdmission(queue_cap=3), fused=True)
    sf = rf.run_report.extras["serve"]
    assert sf["fused"] is True, sf.get("fused_fallback")
    assert sf["host_hops"] == 0
    assert ru.run_report.extras["serve"]["host_hops"] > 0
    assert ru.json_str() == rf.json_str()


def test_device_admission_matches_the_host_policies():
    """Each policy's torch ``device_admit`` is its numpy ``admit``, round
    for round, the token bucket's float32 tokens bit for bit."""
    rng = np.random.default_rng(0)
    windows = np.array([4, 7])
    for name in ("admit-all", "window-slack", "token-bucket"):
        host, dev = _policy(load, name), _policy(load, name)
        state = dev.device_init((2, 3))
        for rnd in range(30):
            queued = rng.integers(0, 20, (2, 3))
            backlog = rng.integers(0, 12, (2, 3))
            rel_h, shed_h = host.admit(rnd, queued, backlog, windows)
            rel_d, shed_d, state = dev.device_admit(
                state, torch.as_tensor(queued, dtype=torch.int32),
                torch.as_tensor(backlog, dtype=torch.int32),
                torch.as_tensor(windows, dtype=torch.int32))
            np.testing.assert_array_equal(rel_d.numpy(), rel_h)
            np.testing.assert_array_equal(shed_d.numpy(), shed_h)
        dev.device_commit(state)
        if name == "token-bucket":
            np.testing.assert_array_equal(dev._tokens, host._tokens)
