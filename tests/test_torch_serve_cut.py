"""The port's serve plane through the virtual-synchrony cut
(``ReplicatedEngine.run(fail_at=)``) against the reference's, in float32
on the CPU.

The scenarios are those of ``tests/test_viewchange.py``: a subscriber
killed while tokens are in flight, a slot (publisher) node killed with a
second suspicion wave landing during the wedge (the dead slot's decode
is voided and re-admitted), ``fail_at`` rounds the run never reaches,
and the same under an admission queue cap that sheds the voided
request.  The model, weights and engines are ``test_torch_serve``'s (a
2-layer qwen3-shaped decoder in float32).  Tokens, the ``view_log``
(round, view, closing report, cut logs), ``slot_failures``,
``extras["serve"]``, the delivery logs, the round traces and the slot
maps must be exactly equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.load.admission import ServeAdmission as RefServeAdmission
from repro.models import layers as ref_layers
from repro.serve import engine as ref_engine
from repro.serve.fanout import ReplicatedEngine as RefReplicatedEngine
from repro_torch import api
from test_torch_serve import (INT_FIELDS, SERVE_KEYS, TRACES,  # noqa: F401
                              _assert_logs_equal, params, port_engines,
                              ref_engines)

pytestmark = pytest.mark.fast

BACKENDS = [("graph", "graph"), ("kernel", "pallas")]
VOCAB = 512


def _submit(rep, request_cls, seed, n_per_replica=3, new_tokens=4):
    rng = np.random.default_rng(seed)
    for g in range(2):
        for i in range(n_per_replica):
            rep.submit(g, request_cls(
                rid=g * 10 + i,
                prompt=rng.integers(0, VOCAB, 3, dtype=np.int32),
                max_new_tokens=new_tokens))


def _arrivals(request_cls, seed):
    """One request a replica at each of rounds 0-2: the first two fill
    the slots, the third waits in the queue."""
    rng = np.random.default_rng(seed)
    return [[[request_cls(rid=g * 10 + i,
                          prompt=rng.integers(0, VOCAB, 3, dtype=np.int32),
                          max_new_tokens=4)] for g in range(2)]
            for i in range(3)]


def _run(monkeypatch, port_engines, ref_engines, port_backend,
         ref_backend, fail_at, *, seed=3, subscribers=2, admission=None,
         arrivals=False):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    out = []
    for pkg, engines, backend in (("port", port_engines, port_backend),
                                  ("ref", ref_engines, ref_backend)):
        if pkg == "port":
            rep = api.ReplicatedEngine(engines,
                                       subscribers_per_replica=subscribers,
                                       window=4, backend=backend,
                                       device="cpu")
        else:
            rep = RefReplicatedEngine(engines,
                                      subscribers_per_replica=subscribers,
                                      window=4, backend=backend)
        rep.reset()
        request_cls = api.Request if pkg == "port" else ref_engine.Request
        kw = {}
        if arrivals:
            kw["arrive_schedule"] = _arrivals(request_cls, seed)
        else:
            _submit(rep, request_cls, seed)
        if admission is not None:
            cls = api.ServeAdmission if pkg == "port" else \
                RefServeAdmission
            kw["admission"] = cls(**admission)
        out.append((rep, rep.run(fail_at=fail_at, **kw)))
    (port_rep, got), (ref_rep, want) = out
    _assert_cut_runs_equal(port_rep, ref_rep, got, want)
    return port_rep, got


def _assert_cut_runs_equal(port_rep, ref_rep, got, want):
    assert port_rep.completed() == ref_rep.completed()
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    _assert_logs_equal(got.extras["delivery_logs"],
                       want.extras["delivery_logs"])
    for key in SERVE_KEYS:
        assert got.extras["serve"][key] == want.extras["serve"][key], key
    for name in TRACES:
        assert getattr(port_rep, name) == getattr(ref_rep, name), name
    assert port_rep.slot_failures == ref_rep.slot_failures
    assert port_rep._rank_slot == ref_rep._rank_slot
    assert port_rep._slot_rank == ref_rep._slot_rank
    assert port_rep._dead_slots == ref_rep._dead_slots
    assert port_rep._ms.wedge_retries == ref_rep._ms.wedge_retries
    assert [dataclasses.astuple(v) for v in port_rep._ms.history] == \
        [dataclasses.astuple(v) for v in ref_rep._ms.history]
    assert len(port_rep.view_log) == len(ref_rep.view_log)
    assert len(port_rep.cut_walls) == len(port_rep.view_log)
    for (rn_p, v_p, rep_p, logs_p), (rn_r, v_r, rep_r, logs_r) in zip(
            port_rep.view_log, ref_rep.view_log):
        assert rn_p == rn_r
        assert dataclasses.astuple(v_p) == dataclasses.astuple(v_r)
        _assert_logs_equal(logs_p, logs_r)
        for f in INT_FIELDS:
            assert getattr(rep_p, f) == getattr(rep_r, f), f
        vp, vr = rep_p.extras["view_change"], rep_r.extras["view_change"]
        assert vp["cut_seq"] == vr["cut_seq"]
        assert vp["resend_msgs"] == vr["resend_msgs"]
        for g in vr["stable_apps_by_old_rank"]:
            np.testing.assert_array_equal(
                vp["stable_apps_by_old_rank"][g],
                vr["stable_apps_by_old_rank"][g])


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_subscriber_failure_midrun(monkeypatch, port_engines, ref_engines,
                                   port_backend, ref_backend):
    """Node 3, replica 0's second subscriber, fails while tokens are in
    flight: every request completes, every hold re-pins and releases,
    and the surviving subscriber sees every app message exactly once
    across the two epochs."""
    rep, report = _run(monkeypatch, port_engines, ref_engines,
                       port_backend, ref_backend, {2: [3]})
    serve = report.extras["serve"]
    assert serve["view_changes"] == 1 and serve["drained"]
    assert serve["requests"] == 6 and serve["tokens"] == 6 * 4
    assert serve["held_slots"] == 0
    _, _, old_report, old_logs = rep.view_log[0]
    assert old_report.extras["view_change"]["resend_msgs"] > 0
    seen = sum(1 for log in (old_logs["replica-0"],
                             report.extras["delivery_logs"]["replica-0"])
               for _ in log.sequence(2))
    assert seen == 3 * 5         # 3 requests x (admission + 4 tokens)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_slot_node_failure_with_a_cascade(monkeypatch, port_engines,
                                          ref_engines, port_backend,
                                          ref_backend):
    """Wave 1 kills slot node 0 and subscriber 3, wave 2 (during the
    wedge) subscriber 6: one view installs, the dead slot's decode is
    voided and re-admitted, slot 1 compacts onto rank 0."""
    rep, report = _run(monkeypatch, port_engines, ref_engines,
                       port_backend, ref_backend, {2: [[0, 3], [6]]})
    serve = report.extras["serve"]
    assert serve["view_changes"] == 1 and rep._ms.wedge_retries == 1
    assert serve["drained"] and serve["requests"] == 6
    assert serve["slot_failures"] == 1 and serve["held_slots"] == 0
    [rec] = serve["slot_failure_log"]
    assert (rec["replica"], rec["slot"], rec["node"]) == (0, 0, 0)
    assert rec["voided_rid"] is not None and rec["requeued"]
    assert rep._rank_slot[0] == [1] and rep._slot_rank[0] == {1: 0}
    _, _, old_report, old_logs = rep.view_log[0]
    stable0 = old_report.extras["view_change"][
        "stable_apps_by_old_rank"][0]
    per_epoch = [sum(1 for _ in log.sequence(2)) for log in
                 (old_logs["replica-0"],
                  report.extras["delivery_logs"]["replica-0"])]
    assert per_epoch[0] == int(np.asarray(stable0).sum())
    assert sum(per_epoch) == 3 * 5 + rec["stable_apps"]


def test_unreached_fail_at_rounds_surface(monkeypatch, port_engines,
                                          ref_engines):
    _, report = _run(monkeypatch, port_engines, ref_engines, "kernel",
                     "graph", {500: [2], 900: [[5], [2]]}, seed=5,
                     subscribers=1)
    serve = report.extras["serve"]
    assert serve["drained"] and serve["view_changes"] == 0
    assert serve["fail_at_unreached"] == [500, 900]
    _, report = _run(monkeypatch, port_engines, ref_engines, "kernel",
                     "graph", {1: [2], 700: [5]}, seed=6, subscribers=1)
    serve = report.extras["serve"]
    assert serve["drained"] and serve["view_changes"] == 1
    assert serve["fail_at_unreached"] == [700]


def test_voided_request_is_shed_at_the_queue_cap(monkeypatch, port_engines,
                                                 ref_engines):
    """With the queue at its cap (one request waiting) the dead slot's
    voided request cannot re-enter the queue: it is shed, and completed
    and shed requests partition the submitted ones."""
    rep, report = _run(monkeypatch, port_engines, ref_engines, "kernel",
                       "graph", {2: [4]}, admission=dict(queue_cap=1),
                       arrivals=True)
    serve = report.extras["serve"]
    [rec] = serve["slot_failure_log"]
    assert rec["voided_rid"] is not None and not rec["requeued"]
    assert serve["shed_requests"] == 1
    assert rep.shed_log == [(rec["voided_rid"], 2)]
    done = {r.rid for e in rep.engines for r in e.completed}
    shed = {rid for rid, _ in rep.shed_log}
    assert not done & shed and len(done | shed) == 6


def test_fail_at_must_leave_a_live_slot(port_engines):
    rep = api.ReplicatedEngine(port_engines, subscribers_per_replica=1,
                               window=4, device="cpu")
    rep.reset()
    _submit(rep, api.Request, 3)
    with pytest.raises(ValueError, match="every slot"):
        rep.run(fail_at={1: [0, 1]})
    with pytest.raises(ValueError, match="mixes node ids and waves"):
        rep.run(fail_at={1: [0, [1]]})
