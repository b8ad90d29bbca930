"""The port's chaos plane (``repro_torch.chaos``) against the reference's.

``FaultSpec.sample`` must draw the reference's schedules for each seed,
and ``chaos_soak`` over the port's three targets — a Group stream, a
``ReplicatedEngine`` (the 2-layer float32 decoder of
``test_torch_serve``) and a ``BucketSyncStream`` — must raise no
``InvariantViolation`` and give ``ChaosReport``s equal to the
reference's ``graph`` soak at seeds 11, 23 and 47: every field but the
backend tag, the ``extras`` digests (per-epoch delivery sequences,
per-node app counts, trims, completed tokens, applied rounds) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as ref_api
from repro.chaos import FaultSpec as RefFaultSpec
from repro.chaos import chaos_soak as ref_chaos_soak
from repro.core.gradsync import BucketSyncStream as RefBucketSyncStream
from repro.models import layers as ref_layers
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import engine as ref_engine
from repro.serve.fanout import ReplicatedEngine as RefReplicatedEngine
from repro_torch import api
from repro_torch.chaos import (ChaosReport, FaultEvent, FaultSpec,
                               InvariantViolation, chaos_soak,
                               events_by_round)
from repro_torch.chaos.soak import _Checker
from repro_torch.core.gradsync import BucketSyncStream
from test_torch_serve import (REF_FAN, params, port_engines,  # noqa: F401
                              ref_engines)

pytestmark = pytest.mark.fast

SEEDS = (11, 23, 47)
STREAM_SPEC = dict(rounds=24, suspect_rate=0.25, cascade_prob=0.5,
                   join_rate=0.15, stall_rate=0.15)
GRADSYNC_SPEC = dict(rounds=20, suspect_rate=0.2, cascade_prob=0.5,
                     join_rate=0.2, stall_rate=0.1)
SERVE_SPEC = dict(rounds=14, suspect_rate=0.2, cascade_prob=0.5,
                  slot_kill_rate=0.2, stall_rate=0.1)


def _report(rep):
    out = dataclasses.asdict(rep)
    out.pop("backend")
    return out


def _chaos_group(pkg):
    a = pkg.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1, 2),
                         msg_size=512, window=4, n_messages=0)
    b = pkg.SubgroupSpec(members=(1, 2, 3), senders=(1, 2), msg_size=256,
                         window=4, n_messages=0)
    cfg = pkg.GroupConfig(members=(0, 1, 2, 3, 4), subgroups=(a, b))
    return pkg.Group(cfg, device="cpu") if pkg is api else pkg.Group(cfg)


@pytest.mark.parametrize("seed", [7, 11, 23, 47])
def test_fault_schedules_match_the_reference(seed):
    kw = dict(killable=range(10, 20), joinable=(30, 31, 32),
              slot_groups=((0, 1, 2), (3, 4)))
    spec = dict(rounds=40, suspect_rate=0.3, cascade_prob=0.5,
                join_rate=0.2, slot_kill_rate=0.3, stall_rate=0.2,
                max_kills=6)
    got = FaultSpec(**spec).sample(np.random.default_rng(seed), **kw)
    want = RefFaultSpec(**spec).sample(np.random.default_rng(seed), **kw)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    assert sorted(events_by_round(got)) == sorted({e.round for e in got})
    assert all(isinstance(e, FaultEvent) for e in got)


@pytest.mark.parametrize("port_backend", ["graph", "kernel"])
@pytest.mark.parametrize("seed", SEEDS)
def test_stream_soak_matches_the_reference(port_backend, seed):
    got = chaos_soak(_chaos_group(api), FaultSpec(**STREAM_SPEC),
                     seed=seed, backend=port_backend)
    want = ref_chaos_soak(_chaos_group(ref_api),
                          RefFaultSpec(**STREAM_SPEC), seed=seed,
                          backend="graph")
    assert isinstance(got, ChaosReport) and got.target == "stream"
    assert got.backend == port_backend
    assert _report(got) == _report(want)
    assert got.views_installed >= 1 and got.checks > 30


@pytest.mark.parametrize("seed", SEEDS)
def test_gradsync_soak_matches_the_reference(seed):
    gs = BucketSyncStream([0, 1, 2, 3], n_buckets=2, window=6,
                          backend="kernel", device="cpu")
    got = chaos_soak(gs, FaultSpec(**GRADSYNC_SPEC), seed=seed)
    want = ref_chaos_soak(
        RefBucketSyncStream([0, 1, 2, 3], n_buckets=2, window=6,
                            backend="graph"),
        RefFaultSpec(**GRADSYNC_SPEC), seed=seed)
    assert got.target == "gradsync" and got.backend == "kernel"
    assert _report(got) == _report(want)
    assert got.extras["applied"]


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_soak_matches_the_reference(monkeypatch, port_engines,
                                          ref_engines, seed):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    reports = []
    for rep_cls, engines, request_cls, soak, spec, kw in (
            (api.ReplicatedEngine, port_engines, api.Request, chaos_soak,
             FaultSpec, dict(backend="kernel", device="cpu")),
            (RefReplicatedEngine, ref_engines, ref_engine.Request,
             ref_chaos_soak, RefFaultSpec, dict(backend="graph"))):
        rep = rep_cls(engines, subscribers_per_replica=2, window=4, **kw)
        rep.reset()
        rng = np.random.default_rng(3)
        for g in range(2):
            for i in range(3):
                rep.submit(g, request_cls(
                    rid=g * 10 + i,
                    prompt=rng.integers(0, 512, 3, dtype=np.int32),
                    max_new_tokens=4))
        reports.append(soak(rep, spec(**SERVE_SPEC), seed=seed))
    got, want = reports
    assert got.target == "serve" and got.backend == "kernel"
    assert _report(got) == _report(want)
    assert got.extras["completed_tokens"]


def test_soak_is_deterministic_and_checks_its_targets():
    spec = FaultSpec(rounds=16, suspect_rate=0.25, cascade_prob=0.5,
                     join_rate=0.15, stall_rate=0.1)
    a = chaos_soak(_chaos_group(api), spec, seed=11)
    b = chaos_soak(_chaos_group(api), spec, seed=11)
    assert a.backend == "kernel" and a.extras == b.extras
    assert a.killed == b.killed and a.extras["fault_events"] >= 1
    with pytest.raises(TypeError, match="does not know"):
        chaos_soak(object(), FaultSpec())


def test_fused_and_des_are_not_ported_yet(port_engines):
    """The fused leg is ported: ``chaos_soak(fused=True)`` on a serve
    target drives the fused path where the drawn cuts stay homogeneous
    and falls back, saying so, where they do not — either way the report
    is the unfused soak's but for the path markers; a stream target
    ignores ``fused``, as the reference does.  The DES is not ported:
    ``backend="des"`` raises naming item 13."""
    spec = FaultSpec(**SERVE_SPEC)
    reports = {}
    for fused in (False, True):
        rep = api.ReplicatedEngine(port_engines, subscribers_per_replica=2,
                                   window=4, backend="graph", device="cpu")
        rep.reset()
        rng = np.random.default_rng(3)
        for g in range(2):
            for i in range(3):
                rep.submit(g, api.Request(
                    rid=g * 10 + i,
                    prompt=rng.integers(0, 512, 3, dtype=np.int32),
                    max_new_tokens=4))
        reports[fused] = chaos_soak(rep, spec, seed=23, fused=fused)
    u, f = reports[False], reports[True]
    strip = ("fused", "fused_fallback")
    assert {k: v for k, v in u.extras.items() if k not in strip} == \
        {k: v for k, v in f.extras.items() if k not in strip}
    assert u.killed == f.killed and u.rounds == f.rounds
    assert "heterogeneous" in f.extras["fused_fallback"]
    a = chaos_soak(_chaos_group(api), FaultSpec(), fused=True)
    b = chaos_soak(_chaos_group(api), FaultSpec())
    assert a.extras == b.extras
    with pytest.raises(ValueError, match="item 13"):
        chaos_soak(_chaos_group(api), FaultSpec(), backend="des")


def test_a_failed_check_raises_an_invariant_violation():
    check = _Checker(seed=5)
    check(True, "holds")
    with pytest.raises(InvariantViolation, match=r"\[seed=5\] broke"):
        check(False, "broke", 1, 2)
    assert issubclass(InvariantViolation, AssertionError) and check.n == 2


@pytest.fixture(scope="module")
def ref_shared_engines(params):
    """``test_torch_serve``'s reference engines sharing ONE parameter
    tree, as the reference's fused path requires."""
    shared = jax.tree.map(jnp.asarray, params)
    engines = []
    for _ in range(2):
        eng = ref_engine.ServeEngine(
            "fanout-test", shared, REF_FAN,
            ref_engine.EngineConfig(max_batch=2, max_len=48), RefRuntime())
        eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32), eng.cache)
        engines.append(eng)
    return engines


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_serve_soak_matches_the_reference(monkeypatch, port_engines,
                                                ref_shared_engines, seed):
    """``chaos_soak(fused=True)`` on the serve plane: the port's report,
    its path markers included, is the reference's fused soak's."""
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_engines = ref_shared_engines
    reports = []
    for rep_cls, engines, request_cls, soak, spec, kw in (
            (api.ReplicatedEngine, port_engines, api.Request, chaos_soak,
             FaultSpec, dict(backend="kernel", device="cpu")),
            (RefReplicatedEngine, ref_engines, ref_engine.Request,
             ref_chaos_soak, RefFaultSpec, dict(backend="graph"))):
        rep = rep_cls(engines, subscribers_per_replica=2, window=4, **kw)
        rep.reset()
        rng = np.random.default_rng(3)
        for g in range(2):
            for i in range(3):
                rep.submit(g, request_cls(
                    rid=g * 10 + i,
                    prompt=rng.integers(0, 512, 3, dtype=np.int32),
                    max_new_tokens=4))
        reports.append(soak(rep, spec(**SERVE_SPEC), seed=seed,
                            fused=True))
    got, want = reports
    assert _report(got) == _report(want)
    fb = got.extras["fused_fallback"]
    assert fb is None or "heterogeneous" in fb or "overflow" in fb


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_fused_serve_real_wedge(port_engines, seed):
    """A HOMOGENEOUS mid-run cut (one slot node per replica) stops the
    fused program, cuts on the host and runs a second program: two
    epochs, no fallback, zero host hops, the per-round loop's results.
    A heterogeneous cut (one replica's subscriber) falls back,
    explicitly, to the same results."""
    fail_round = 1 + seed % 3

    def drive(fused, fail_nodes):
        rep = api.ReplicatedEngine(port_engines, subscribers_per_replica=2,
                                   window=4, backend="graph", device="cpu")
        rep.reset()
        rng = np.random.default_rng(seed)
        for g in range(2):
            for i in range(3):
                rep.submit(g, api.Request(
                    rid=g * 10 + i,
                    prompt=rng.integers(0, 512, 3, dtype=np.int32),
                    max_new_tokens=4))
        report = rep.run(fail_at={fail_round: fail_nodes(rep)},
                         fused=fused)
        return rep.completed(), report

    def homogeneous(rep):
        return [rep._slot_nodes[0][1], rep._slot_nodes[1][1]]

    done_u, rep_u = drive(False, homogeneous)
    done_f, rep_f = drive(True, homogeneous)
    serve = rep_f.extras["serve"]
    assert serve["fused"] is True, serve.get("fused_fallback")
    assert serve["fused_epochs"] == 2 and serve["host_hops"] == 0
    assert serve["view_changes"] == 1 and serve["drained"]
    assert done_f == done_u
    su = rep_u.extras["serve"]
    for k in ("engine_rounds", "view_changes", "voided_requests",
              "requeued_requests", "slot_failures", "fail_at_unreached"):
        assert su[k] == serve[k], k
    # replica 0's nodes: slots 0-1, subscribers 2-3
    done_hu, _ = drive(False, lambda r: [2])
    done_hf, rep_hf = drive(True, lambda r: [2])
    s_het = rep_hf.extras["serve"]
    assert s_het["fused"] is False and "fail_at" in s_het["fused_fallback"]
    assert s_het["view_changes"] == 1 and done_hf == done_hu
