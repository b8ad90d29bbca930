"""The port's gradient reduction through the cut (``BucketSyncStream``)
and its elastic runtime (``ElasticRuntime``) against the reference's.

The schedules are those of ``tests/test_chaos.py``: an elastic JOIN
resize with no failure, and a failure that voids only the dead
contributor.  Port ``"graph"`` and ``"kernel"`` on ``device="cpu"`` run
against the reference's ``"graph"``.  Each runtime step's record, every
worker's ``delivered_step``, the view changes, and the applied ledger
(step, contributors, voided) must be identical; each applied update is
the contributors' mean ``sum(xs) / len(xs)``, one operation at a time
in ledger order on both sides, so it is held EXACTLY (float32 tensors
against float32 jax arrays, and Python floats).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gradsync import BucketSyncStream as RefBucketSyncStream
from repro.train.elastic import ElasticConfig as RefElasticConfig
from repro.train.elastic import ElasticRuntime as RefElasticRuntime
from repro_torch.core.gradsync import AppliedRound, BucketSyncStream
from repro_torch.train.elastic import ElasticConfig, ElasticRuntime

pytestmark = pytest.mark.fast

PORT_BACKENDS = ("graph", "kernel")


def _upd(node, rnd):
    return {"w": float((node + 1) * rnd) * 0.01}


def _tensor_upd(pkg):
    """Seeded float32 contributions, as torch tensors for the port and
    jax arrays for the reference: a two-leaf tree per (node, round)."""
    def upd(node, rnd):
        rng = np.random.default_rng(1000 * node + rnd)
        leaves = {"a": rng.standard_normal((3, 5)).astype(np.float32),
                  "b": [rng.standard_normal(7).astype(np.float32)]}
        conv = torch.from_numpy if pkg == "port" else jnp.asarray
        return {"a": conv(leaves["a"]), "b": [conv(leaves["b"][0])]}
    return upd


def _make(pkg, backend, members, **kw):
    if pkg == "port":
        return BucketSyncStream(members, backend=backend, device="cpu",
                                **kw)
    return RefBucketSyncStream(members, backend=backend, **kw)


def _records(rt, gs):
    return ([(w.node, w.heartbeat, w.delivered_step, w.alive, w.lag)
             for w in sorted(rt.workers.values(), key=lambda w: w.node)],
            [dataclasses.astuple(v) for v in rt.view_changes],
            gs.applied_step if gs is not None else None)


def _assert_applied_equal(got, want):
    assert [(a.step, a.contributors, a.voided) for a in got] == \
        [(a.step, a.contributors, a.voided) for a in want]
    for a, b in zip(got, want):
        assert (a.update is None) == (b.update is None)
        if b.update is None:
            continue
        if "w" in b.update:
            assert a.update["w"] == b.update["w"]          # bit for bit
            continue
        for x, y in ((a.update["a"], b.update["a"]),
                     (a.update["b"][0], b.update["b"][0])):
            assert x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _join_resize(pkg, backend, upd):
    """tests/test_chaos.py's join resize: 3 workers, 4 rounds, node 3
    joins, 5 rounds more."""
    rt = (ElasticRuntime([0, 1, 2], ElasticConfig()) if pkg == "port"
          else RefElasticRuntime([0, 1, 2], RefElasticConfig()))
    gs = _make(pkg, backend, [0, 1, 2], n_buckets=2, window=6)
    rt.attach_gradient_stream(gs, upd)
    steps = []
    for rnd in range(9):
        if rnd == 4:
            rt.join(3)
        steps.append((rt.step(), _records(rt, rt.gradsync)))
    report = rt.gradsync.finish()
    assert not report.stalled
    return rt, steps


def _failure(pkg, backend, upd):
    """tests/test_chaos.py's failure: 4 workers, node 3 fails in round
    3, heartbeat timeout 2, 10 rounds."""
    rt = (ElasticRuntime([0, 1, 2, 3], ElasticConfig(heartbeat_timeout=2))
          if pkg == "port" else
          RefElasticRuntime([0, 1, 2, 3],
                            RefElasticConfig(heartbeat_timeout=2)))
    gs = _make(pkg, backend, [0, 1, 2, 3], n_buckets=2, window=4)
    rt.attach_gradient_stream(gs, upd)
    steps = []
    for rnd in range(10):
        if rnd == 3:
            rt.fail(3)
        steps.append((rt.step(), _records(rt, rt.gradsync)))
    report = rt.gradsync.finish()
    assert not report.stalled
    return rt, steps


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
@pytest.mark.parametrize("tensors", [False, True])
def test_join_resize_matches_the_reference(port_backend, tensors):
    """With no failure, routing the reduction through the stream changes
    WHEN updates apply but not WHAT applies: every applied mean equals
    the reference's bit for bit, through an elastic join."""
    upd_p = _tensor_upd("port") if tensors else _upd
    upd_r = _tensor_upd("ref") if tensors else _upd
    rt_p, steps_p = _join_resize("port", port_backend, upd_p)
    rt_r, steps_r = _join_resize("ref", "graph", upd_r)
    assert steps_p == steps_r
    _assert_applied_equal(rt_p.gradsync.applied, rt_r.gradsync.applied)
    applied = rt_p.gradsync.applied
    assert len(rt_p.view_changes) == 1
    assert any(len(a.contributors) == 4 for a in applied)
    assert all(not a.voided for a in applied)
    assert [a.step for a in applied] == list(range(9))
    if not tensors:
        for a, (res, _) in zip(applied, steps_p):
            want = float(np.mean([_upd(m, res["round"])["w"]
                                  for m in sorted(a.contributors)]))
            assert a.update["w"] == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
@pytest.mark.parametrize("tensors", [False, True])
def test_failure_voids_only_the_dead_contributor(port_backend, tensors):
    upd_p = _tensor_upd("port") if tensors else _upd
    upd_r = _tensor_upd("ref") if tensors else _upd
    rt_p, steps_p = _failure("port", port_backend, upd_p)
    rt_r, steps_r = _failure("ref", "graph", upd_r)
    assert steps_p == steps_r
    _assert_applied_equal(rt_p.gradsync.applied, rt_r.gradsync.applied)
    gs = rt_p.gradsync
    assert len(rt_p.view_changes) == 1
    assert 3 not in rt_p.view_changes[0].members
    assert all(set(a.voided) <= {3} for a in gs.applied)
    assert any(a.voided for a in gs.applied)
    # delivered_step never rolls back for any worker
    for node in (0, 1, 2, 3):
        marks = [rec[0][node][2] for _, rec in steps_p]
        assert all(b >= a for a, b in zip(marks, marks[1:])), node
    assert gs._dead == rt_r.gradsync._dead
    assert gs._base == rt_r.gradsync._base


@pytest.mark.parametrize("seed", [0, 1])
def test_runtime_without_a_stream_rolls_back_to_the_watermark(seed):
    """The restart-style path: a failure rolls every survivor back to
    the checkpoint watermark, identically on both packages; stragglers
    take null rounds."""
    out = []
    for rt in (ElasticRuntime([0, 1, 2, 3, 4],
                              ElasticConfig(heartbeat_timeout=3)),
               RefElasticRuntime([0, 1, 2, 3, 4],
                                 RefElasticConfig(heartbeat_timeout=3))):
        rng = np.random.default_rng(seed)
        steps = []
        for rnd in range(12):
            event = int(rng.integers(0, 6))
            live = [m for m in rt.view.members if rt.workers[m].alive]
            if event == 0 and len(live) > 2:
                rt.fail(live[-1])
            elif event == 1 and live:
                rt.delay(live[0], int(rng.integers(1, 3)))
            elif event == 2:
                rt.join(10 + rnd)
            steps.append((rt.step(), _records(rt, None),
                          rt.restart_watermark()))
        out.append(steps)
    assert out[0] == out[1]
    assert any(s[0]["view_change"] is not None for s in out[0])


def test_bucket_stream_rejects_bad_input_and_runs_on_the_device_given():
    with pytest.raises(ValueError, match="at least one bucket"):
        BucketSyncStream([0, 1], n_buckets=0, device="cpu")
    gs = BucketSyncStream([0, 1], n_buckets=2, device="cpu")
    assert gs.group.device == torch.device("cpu")
    assert gs._stream.backend.name == "kernel"
    with pytest.raises(ValueError, match="not a live member"):
        gs.contribute({5: {"w": 1.0}})
    gs.contribute({0: {"w": 1.0}, 1: {"w": 2.0}})
    gs.finish()
    assert gs.applied == [AppliedRound(step=0, contributors=(0, 1),
                                       update={"w": 1.5})]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BucketSyncStream([0, 1], n_buckets=2)
