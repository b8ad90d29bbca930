"""The port's fused serve program (``repro_torch.serve.fused``,
``ReplicatedEngine.run(fused=True)``) against the port's per-round loop
and the reference's fused run, in float32 on the CPU.

The cases are ``tests/test_serve_fused.py``'s dense ones: closed
workloads on ``graph`` and ``kernel``, the warm run building nothing,
explicit fallbacks with the reference's reasons, open-loop arrivals with
``ServeAdmission`` and stall masks, a mid-run cut, programs reused when
shapes repeat, per-run maxima and ``_owner_fill``.  A fused run must
equal the per-round loop EXACTLY (tokens, per-topic delivery logs, the
admit / finish / free / shed traces, queue-depth and backlog logs, the
report), and the reference's fused run in tokens and logs.  The model
and weights are ``test_torch_serve``'s (a 2-layer decoder, float32).
On the CPU the round body runs eagerly, IF node by IF node
(``repro_torch.core.graphloop``).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import group as ref_group
from repro.load.admission import ServeAdmission as RefServeAdmission
from repro.models import layers as ref_layers
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import engine as ref_engine
from repro.serve import fused as ref_fused
from repro.serve.fanout import ReplicatedEngine as RefReplicatedEngine
from repro_torch import api
from repro_torch.core import graphloop
from repro_torch.core import group as group_mod
from repro_torch.models import convert
from repro_torch.serve import fused as fused_mod
from test_torch_serve import FAN, REF_FAN, _assert_logs_equal, params  # noqa: F401,E501

pytestmark = pytest.mark.fast

MAX_LEN, VOCAB = 48, 512
BACKENDS = [("graph", "graph"), ("kernel", "pallas")]


@pytest.fixture(scope="module")
def port_params(params):
    return convert.params_from_numpy(params, FAN, "cpu", torch.float32)


@pytest.fixture(scope="module")
def ref_params(params):
    return jax.tree.map(jnp.asarray, params)


def _engines(port_params, slots):
    return [api.ServeEngine("fanout-test", port_params, FAN,
                            api.EngineConfig(max_batch=slots,
                                             max_len=MAX_LEN),
                            device="cpu") for _ in range(2)]


def _ref_engines(ref_params, slots):
    engines = []
    for _ in range(2):
        eng = ref_engine.ServeEngine(
            "fanout-test", ref_params, REF_FAN,
            ref_engine.EngineConfig(max_batch=slots, max_len=MAX_LEN),
            RefRuntime())
        eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32),
                                 eng.cache)
        engines.append(eng)
    return engines


def _requests(request_cls, reqs, seed=7, prompt=3, new_tokens=4):
    rng = np.random.default_rng(seed)
    return [[request_cls(rid=g * 10 + i,
                         prompt=rng.integers(1, VOCAB, size=prompt)
                         .astype(np.int32),
                         max_new_tokens=new_tokens)
             for i in range(reqs)] for g in range(2)]


def _schedule(request_cls, rounds=8, seed=3, kind="poisson", rate=0.8):
    """Seeded open-loop arrival schedule (the reference test's)."""
    rng = np.random.default_rng(seed)
    sched, rid = [], 100
    for _t in range(rounds):
        row = []
        for _g in range(2):
            k = int(rng.poisson(rate)) if kind == "poisson" \
                else 3 * int(rng.random() < 0.3)
            cell = []
            for _ in range(k):
                cell.append(request_cls(
                    rid=rid, prompt=rng.integers(1, VOCAB, size=3)
                    .astype(np.int32), max_new_tokens=4))
                rid += 1
            row.append(cell)
        sched.append(row)
    return sched


def _rep(engines, backend, *, reqs=3, stall_fn=None, seed=7):
    rep = api.ReplicatedEngine(engines, subscribers_per_replica=1,
                               window=4, backend=backend, stall_fn=stall_fn,
                               device="cpu")
    return _resubmit(rep, reqs=reqs, seed=seed)


def _resubmit(rep, *, reqs=3, seed=7):
    rep.reset()
    for g, per in enumerate(_requests(api.Request, reqs, seed)):
        for req in per:
            rep.submit(g, req)
    return rep


def _ref_rep(engines, backend, *, reqs=3, stall_fn=None, seed=7):
    rep = RefReplicatedEngine(engines, subscribers_per_replica=1, window=4,
                              backend=backend, stall_fn=stall_fn)
    rep.reset()
    for g, per in enumerate(_requests(ref_engine.Request, reqs, seed)):
        for req in per:
            rep.submit(g, req)
    return rep


TRACES = ("admit_rounds", "admit_slots", "finish_rounds", "free_rounds",
          "finish_round_by_rid", "queue_depth_log", "backlog_log",
          "shed_log", "submit_rounds", "stall_rounds")
SERVE_KEYS = ("replicas", "engine_rounds", "drained", "decode_steps",
              "requests", "tokens", "stall_rounds", "held_slots",
              "view_changes", "slot_failures", "voided_requests",
              "requeued_requests", "slot_failure_log", "fail_at_unreached",
              "shed_requests", "max_queue_depth", "max_backlog")
INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled")


def _assert_conformant(rep_u, r_u, rep_f, r_f):
    """The fused run equals the per-round loop exactly."""
    sf = r_f.extras["serve"]
    assert sf["fused"] is True, sf.get("fused_fallback")
    assert sf["host_hops"] == 0
    assert r_u.extras["serve"]["host_hops"] > 0
    assert rep_u.completed() == rep_f.completed()
    _assert_logs_equal(r_f.extras["delivery_logs"],
                       r_u.extras["delivery_logs"])
    for name in TRACES:
        assert getattr(rep_u, name) == getattr(rep_f, name), name
    for f in INT_FIELDS:
        assert getattr(r_u, f) == getattr(r_f, f), f
    np.testing.assert_allclose(r_f.duration_us, r_u.duration_us,
                               rtol=1e-6)
    assert r_u.extras["streamed_rounds"] == r_f.extras["streamed_rounds"]
    for k in SERVE_KEYS:
        assert r_u.extras["serve"][k] == sf[k], k
    assert sf["drained"]


def _assert_matches_reference(rep_f, r_f, ref_rep, r_ref):
    """The port's fused run against the reference's: tokens and logs."""
    assert r_ref.extras["serve"]["fused"] is True
    assert rep_f.completed() == ref_rep.completed()
    _assert_logs_equal(r_f.extras["delivery_logs"],
                       r_ref.extras["delivery_logs"])
    for name in ("admit_rounds", "finish_rounds", "free_rounds"):
        assert getattr(rep_f, name) == getattr(ref_rep, name), name
    for k in ("fused_epochs", "fused_rounds", "fused_round_budget",
              "engine_rounds"):
        assert r_f.extras["serve"][k] == r_ref.extras["serve"][k], k


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_fused_bit_identical_to_round_loop(monkeypatch, port_params,
                                           ref_params, backend,
                                           ref_backend):
    engines = _engines(port_params, 2)
    rep_u = _rep(engines, backend)
    r_u = rep_u.run()
    rep_f = _rep(engines, backend)
    r_f = rep_f.run(fused=True)
    _assert_conformant(rep_u, r_u, rep_f, r_f)
    assert set(r_f.extras["serve"]) == set(r_u.extras["serve"]) | {
        "fused_rounds", "fused_round_budget", "fused_epochs"}
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_rep = _ref_rep(_ref_engines(ref_params, 2), ref_backend)
    _assert_matches_reference(rep_f, r_f, ref_rep,
                              ref_rep.run(fused=True))
    assert set(r_f.extras["serve"]) == set(ref_rep.last_report.extras[
        "serve"])


def test_fused_warm_run_is_one_program_zero_hops(port_params):
    """A cold fused run builds one round program; a warm run of the same
    shape on the same replicated engine builds none and takes zero host
    hops.  The program is kept on that engine: another one over the same
    replicas builds its own, and a program goes when its engine does."""
    engines = _engines(port_params, 2)
    n0 = len(group_mod.trace_snapshot())
    rep = _rep(engines, "graph")
    rep.run(fused=True)
    assert len(group_mod.trace_snapshot()) - n0 == 1
    n0 = len(group_mod.trace_snapshot())
    r = _resubmit(rep).run(fused=True)
    assert len(group_mod.trace_snapshot()) - n0 == 0, \
        "warm fused run built a program"
    assert r.extras["serve"]["fused"] is True
    assert r.extras["serve"]["host_hops"] == 0
    (prog,) = rep._fused_programs.values()
    gone = weakref.ref(prog)
    other = _rep(engines, "graph")
    other.run(fused=True)
    assert len(group_mod.trace_snapshot()) - n0 == 1
    assert other._fused_programs[next(iter(rep._fused_programs))] \
        is not prog
    del rep, prog
    gc.collect()
    assert gone() is None, "a fused program outlived its engine"


def _stall(g, rnd):
    return (0,) if rnd in (2, 3) else ()


def test_fused_fallback_is_explicit(port_params):
    """A workload the fused program cannot express (client stalls as a
    callback) runs the per-round loop and SAYS so, with results
    identical to asking for the loop directly."""
    engines = _engines(port_params, 2)
    rep_u = _rep(engines, "graph", stall_fn=_stall)
    r_u = rep_u.run()
    rep_f = _rep(engines, "graph", stall_fn=_stall)
    r_f = rep_f.run(fused=True)
    sf = r_f.extras["serve"]
    assert sf["fused"] is False
    assert "stall" in sf["fused_fallback"]
    assert rep_u.completed() == rep_f.completed()
    assert r_u.extras["serve"]["engine_rounds"] == sf["engine_rounds"]
    assert sf["drained"] and sf["requests"] == 6


FALLBACKS = {
    "arrive_fn": dict(arrive_fn=lambda g, rnd: ()),
    "stall_fn": dict(stall_fn=_stall),
    "stall_mask_shape": dict(stall_fn=np.zeros((4, 3, 2), bool)),
    "settle_max": dict(settle_max=3),
    "heterogeneous_cut": dict(fail_at={2: [[2]]}),
    "unknown_node": dict(fail_at={2: [[99]]}),
    "empty_workload": dict(reqs=0),
    "long_request": dict(new_tokens=60),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_reasons_are_the_references(port_params, ref_params,
                                             case):
    """``fused_fallback_reason`` gives the reference's words for every
    workload the fused program cannot express."""
    kw = dict(FALLBACKS[case])
    reqs, new_tokens = kw.pop("reqs", 3), kw.pop("new_tokens", 4)
    stall = kw.pop("stall_fn", None)
    reasons = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            engines = _engines(port_params, 2)
            rep = api.ReplicatedEngine(engines, window=4, stall_fn=stall,
                                       device="cpu")
            req_cls, fn = api.Request, fused_mod.fused_fallback_reason
        else:
            engines = _ref_engines(ref_params, 2)
            rep = RefReplicatedEngine(engines, window=4, stall_fn=stall)
            req_cls, fn = ref_engine.Request, ref_fused.fused_fallback_reason
        rep.reset()
        for g, per in enumerate(_requests(req_cls, reqs,
                                          new_tokens=new_tokens)):
            for req in per:
                rep.submit(g, req)
        reasons.append(fn(rep, **kw))
    assert reasons[0] == reasons[1] and reasons[0] is not None


@pytest.mark.parametrize("backend,kind", [
    ("graph", "poisson"), ("kernel", "poisson"), ("graph", "bursty")])
def test_fused_dynamic_workload_bit_identical(monkeypatch, port_params,
                                              ref_params, backend, kind):
    """Open-loop arrivals + ServeAdmission (queue-cap sheds, watermark
    stalls) + a scheduled stall mask run in the fused program and
    reproduce the per-round loop bit for bit, and the reference's fused
    run."""
    stall = np.zeros((8, 2, 2), bool)
    stall[2, 0, 1] = True
    stall[3, 1, 0] = True
    engines = _engines(port_params, 2)
    adm = api.ServeAdmission(queue_cap=2, stall_backlog=6)
    rep_u = _rep(engines, backend, reqs=2, stall_fn=stall)
    r_u = rep_u.run(arrive_schedule=_schedule(api.Request, kind=kind),
                    admission=adm)
    rep_f = _rep(engines, backend, reqs=2, stall_fn=stall)
    r_f = rep_f.run(arrive_schedule=_schedule(api.Request, kind=kind),
                    admission=adm, fused=True)
    assert rep_u.shed_log == rep_f.shed_log
    su, sf = r_u.extras["serve"], r_f.extras["serve"]
    for k in ("stall_rounds", "shed_requests", "max_queue_depth",
              "max_backlog"):
        assert su[k] == sf[k], k
    _assert_conformant(rep_u, r_u, rep_f, r_f)
    if kind == "poisson":
        monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
        ref_backend = dict(BACKENDS)[backend]
        ref_rep = _ref_rep(_ref_engines(ref_params, 2), ref_backend,
                           reqs=2, stall_fn=stall)
        r_ref = ref_rep.run(
            arrive_schedule=_schedule(ref_engine.Request, kind=kind),
            admission=RefServeAdmission(queue_cap=2, stall_backlog=6),
            fused=True)
        _assert_matches_reference(rep_f, r_f, ref_rep, r_ref)
        assert rep_f.shed_log == ref_rep.shed_log


def test_fused_dynamics_do_not_fall_back(port_params):
    """The workloads the fused program carries give no fallback reason;
    arbitrary host callbacks still do, explicitly."""
    engines = _engines(port_params, 3)
    rep = _rep(engines, "graph", reqs=4, stall_fn=np.zeros((4, 2, 3), bool))
    cut = {3: [[rep._slot_nodes[0][1], rep._slot_nodes[1][1]]]}
    assert fused_mod.fused_fallback_reason(
        rep, fail_at=cut, arrive_schedule=_schedule(api.Request, rounds=2),
        admission=api.ServeAdmission(queue_cap=2, stall_backlog=4)) is None
    assert "arrive_fn" in fused_mod.fused_fallback_reason(
        rep, arrive_fn=lambda g, rnd: ())


def _homogeneous_cut(rep):
    # one slot node per replica at round 3: both replicas stay 2-slot
    return {3: [rep._slot_nodes[0][1], rep._slot_nodes[1][1]]}


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_fused_mid_run_cut_matches_unfused_fail_at(monkeypatch, port_params,
                                                  ref_params, backend,
                                                  ref_backend):
    """One homogeneous cut: the fused loop stops at the failure round,
    the host cuts, a second program runs the next epoch; every closing
    epoch's report and cut logs equal the per-round loop's."""
    engines = _engines(port_params, 3)
    rep_u = _rep(engines, backend, reqs=4)
    r_u = rep_u.run(fail_at=_homogeneous_cut(rep_u))
    rep_f = _rep(engines, backend, reqs=4)
    r_f = rep_f.run(fail_at=_homogeneous_cut(rep_f), fused=True)
    sf = r_f.extras["serve"]
    assert sf["fused_epochs"] == 2
    assert len(rep_u.view_log) == len(rep_f.view_log) == 1
    for (ru_rnd, vu, ru_rep, ru_logs), (rf_rnd, vf, rf_rep, rf_logs) \
            in zip(rep_u.view_log, rep_f.view_log):
        assert ru_rnd == rf_rnd and vu.members == vf.members
        for f in INT_FIELDS:
            assert getattr(ru_rep, f) == getattr(rf_rep, f), f
        np.testing.assert_equal(rf_rep.extras["view_change"],
                                ru_rep.extras["view_change"])
        _assert_logs_equal(rf_logs, ru_logs)
    assert rep_u.slot_failures == rep_f.slot_failures
    assert rep_u.cut_walls and rep_f.cut_walls
    _assert_conformant(rep_u, r_u, rep_f, r_f)
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_rep = _ref_rep(_ref_engines(ref_params, 3), ref_backend, reqs=4)
    r_ref = ref_rep.run(fail_at=_homogeneous_cut(ref_rep), fused=True)
    _assert_matches_reference(rep_f, r_f, ref_rep, r_ref)
    assert [r["voided_rid"] for r in rep_f.slot_failures] == \
        [r["voided_rid"] for r in ref_rep.slot_failures]


def test_fused_cut_reuses_programs_when_shapes_repeat(port_params):
    """Each epoch shape builds one program once; a repeat run of the
    same cut on the same replicated engine builds none."""
    engines = _engines(port_params, 3)
    n0 = len(group_mod.trace_snapshot())
    rep = _rep(engines, "graph", reqs=4)
    cut = _homogeneous_cut(rep)
    rep.run(fail_at=cut, fused=True)
    assert len(group_mod.trace_snapshot()) - n0 == 2
    _resubmit(rep, reqs=4)
    n0 = len(group_mod.trace_snapshot())
    r = rep.run(fail_at=cut, fused=True)
    assert r.extras["serve"]["fused_epochs"] == 2
    assert len(group_mod.trace_snapshot()) - n0 == 0, \
        "a shape-preserving cut built a fused epoch program again"


def test_fused_second_run_reports_per_run_maxima(port_params):
    """extras['serve'] maxima cover THIS run only: a light run after a
    heavy one on the same engines does not inherit its peaks."""
    def drive(fused):
        rep = _rep(_engines(port_params, 2), "graph", reqs=4)
        s1 = rep.run(fused=fused).extras["serve"]
        for g in range(2):
            rep.submit(g, api.Request(
                rid=900 + g, prompt=np.arange(1, 4, dtype=np.int32),
                max_new_tokens=2))
        s2 = rep.run(fused=fused).extras["serve"]
        return s1, s2

    s1f, s2f = drive(True)
    assert s1f["fused"] is True and s2f["fused"] is True
    _s1u, s2u = drive(False)
    for k in ("max_queue_depth", "max_backlog"):
        assert s2f[k] == s2u[k], k
    assert s2f["max_queue_depth"] < s1f["max_queue_depth"]


@pytest.mark.parametrize("seed", range(3))
def test_owner_fill_matches_reference_column_scan(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        t_n = int(rng.integers(1, 12))
        g_n = int(rng.integers(1, 3))
        b = int(rng.integers(1, 4))
        adm = np.where(rng.random((t_n, g_n, b)) < 0.3,
                       rng.integers(0, 9, (t_n, g_n, b)),
                       -1).astype(np.int32)
        init = rng.integers(-1, 5, (g_n, b)).astype(np.int32)
        got = fused_mod._owner_fill(adm, init)
        np.testing.assert_array_equal(got, ref_fused._owner_fill(adm, init))
        want = np.empty_like(got)
        for t in range(t_n):
            for g in range(g_n):
                for s in range(b):
                    own = init[g, s]
                    for u in range(t + 1):
                        if adm[u, g, s] >= 0:
                            own = adm[u, g, s]
                    want[t, g, s] = own
        np.testing.assert_array_equal(got, want)
    z = fused_mod._owner_fill(np.zeros((0, 2, 2), np.int32),
                              np.zeros((2, 2), np.int32))
    assert z.shape == (0, 2, 2)


def test_round_budget_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        args = [int(x) for x in rng.integers(1, 40, 6)]
        kw = dict(arrive_rounds=int(rng.integers(0, 30)),
                  stall_slack=int(rng.integers(0, 10)))
        assert fused_mod._round_budget(*args, **kw) == \
            ref_fused._round_budget(*args, **kw)


def test_cond_and_round_program_run_eagerly_on_the_cpu():
    """On the CPU ``cond`` reads its predicate on the host and a
    ``RoundProgram`` runs rounds until its flag drops, reading no flag
    through the chunked replay path."""
    ran = []
    graphloop.cond(torch.tensor(True), lambda: ran.append(1))
    graphloop.cond(torch.tensor(False), lambda: ran.append(2))
    assert ran == [1]
    state = {"running": torch.tensor(True), "t": torch.tensor(0),
             "x": torch.zeros(3)}

    def round_fn(s):
        graphloop.cond(s["t"] % 2 == 0, lambda: s["x"].add_(1))
        s["t"].add_(1)
        s["running"].copy_(s["t"] < 5)

    prog = graphloop.RoundProgram(state, round_fn, torch.device("cpu"))
    assert prog.run() == 0
    assert int(state["t"]) == 5 and state["x"].tolist() == [3.0] * 3
    assert prog.graph is None
    with pytest.raises(ValueError, match="one-element bool"):
        graphloop._Capture(torch.device("cpu"), False).emit_if(
            torch.zeros(2, dtype=torch.bool), lambda: None)


def test_reference_trace_events_are_untouched_by_the_port():
    """The port's program history is its own deque, bounded like the
    reference's."""
    assert group_mod.TRACE_EVENTS is not ref_group.TRACE_EVENTS
    assert group_mod.TRACE_EVENTS.maxlen == ref_group.TRACE_MAXLEN


def test_fused_program_wants_one_device(port_params):
    """The round program holds the decode caches and the multicast
    carry together: engines and multicast on different devices raise."""
    engines = _engines(port_params, 2)
    rep = _rep(engines, "graph")
    rep.device = torch.device("meta")
    with pytest.raises(ValueError, match="on one device"):
        rep.run(fused=True)
