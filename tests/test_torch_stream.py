"""The port's streaming substrate (``Group.stream`` / ``GroupStream`` and
``Domain.bind`` / ``BoundDomain``) against the reference's.

The scenarios are those of ``tests/test_serve_fanout.py``'s streaming
cases plus a heterogeneous (masked) domain and a null-send-off drain.
Port ``"graph"`` is held against reference ``"graph"`` and port
``"kernel"`` against reference ``"pallas"`` (its Pallas kernel in
interpret mode), both fed the same rounds: every ``StreamView``, the
traces, ``app_publish_index`` answers, delivery logs and integer report
fields must be identical; float report fields (the float32 cost fold)
are held at rtol=1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro_torch import api as port_api
from repro_torch.core import group as port_group
from repro_torch.kernels import ops

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

BACKENDS = [("graph", "graph"), ("kernel", "pallas")]
INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled")
FLOAT_FIELDS = ("throughput_GBps", "mean_latency_us", "p99_latency_us",
                "duration_us")
VIEW_FIELDS = ("delivered_num", "published", "backlog", "app_pub", "nulls")


def _assert_views_equal(got, want):
    assert got.round == want.round
    assert got.n_members == want.n_members
    assert got.n_senders == want.n_senders
    for f in VIEW_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    for gid in range(len(want.n_members)):
        np.testing.assert_array_equal(got.sender_delivered(gid),
                                      want.sender_delivered(gid))
        np.testing.assert_array_equal(got.sender_drained(gid),
                                      want.sender_drained(gid))


def _assert_streams_equal(got, want):
    assert got.shape == want.shape and got.rounds == want.rounds
    assert got.n_members == want.n_members
    assert got.n_senders == want.n_senders and got.windows == want.windows
    np.testing.assert_array_equal(got.cost_params, want.cost_params)
    for a, b in zip(got.traces(), want.traces()):
        np.testing.assert_array_equal(a, b)
    _assert_views_equal(got.view(), want.view())
    assert got.quiescent() == want.quiescent()
    for gid, s_g in enumerate(want.n_senders):
        for rank in range(s_g):
            for k in range(0, 12):
                assert got.app_publish_index(gid, rank, k) == \
                    want.app_publish_index(gid, rank, k), (gid, rank, k)


def _assert_logs_equal(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.n_senders == w.n_senders
        assert g.delivered_seq == w.delivered_seq, key
        assert len(g.is_app) == len(w.is_app)
        for x, y in zip(g.is_app, w.is_app):
            np.testing.assert_array_equal(x, y, err_msg=str(key))


def _assert_reports_equal(got, want):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=0, err_msg=f)
    assert got.extras["streamed_rounds"] == want.extras["streamed_rounds"]


def _drive(port_stream, ref_stream, rounds, finish_kw=None):
    """Feed both streams the same ready rows, comparing each step's view;
    then finish both and compare everything."""
    for ready in rounds:
        _assert_views_equal(port_stream.step(ready), ref_stream.step(ready))
    _assert_streams_equal(port_stream, ref_stream)
    got = port_stream.finish(**(finish_kw or {}))
    want = ref_stream.finish(**(finish_kw or {}))
    _assert_streams_equal(port_stream, ref_stream)
    _assert_reports_equal(got[0], want[0])
    _assert_logs_equal(got[1], want[1])
    return got


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_stream_matches_reference_and_scheduled_run(port_backend,
                                                    ref_backend):
    cfg_args = dict(n_senders=2, msg_size=4096, window=4, n_messages=10)
    port_g = port_api.Group(port_api.single_group(4, **cfg_args),
                            device="cpu")
    ref_g = ref_api.Group(ref_api.single_group(4, **cfg_args))
    port_s = port_g.stream(backend=port_backend)
    ref_s = ref_g.stream(backend=ref_backend)
    ready = np.zeros(port_s.shape, np.int32)
    ready[0, :2] = 1
    report, logs = _drive(port_s, ref_s, [ready] * 10)
    assert port_s.quiescent() and not report.stalled
    # finish() installs logs + report on the Group like run() does
    assert port_g.delivery_logs[0] is logs[0]
    assert port_g.last_report is report
    sched = port_api.Group(port_api.single_group(4, **cfg_args),
                           device="cpu")
    sched.run(backend=port_backend)
    for node in port_g.cfg.subgroups[0].members:
        assert logs[0].sequence(node) == \
            sched.delivery_logs[0].sequence(node)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_finish_drains_a_large_backlog_and_caps(port_backend, ref_backend):
    """finish() is not a fixed settle budget: 200 messages/sender through
    window=4 drain to quiescence; a capped drain reports the cut-off."""
    cfg_args = dict(n_senders=2, msg_size=256, window=4, n_messages=0)
    for finish_kw in ({}, {"settle_max": 5}):
        port_s = port_api.Group(port_api.single_group(4, **cfg_args),
                                device="cpu").stream(backend=port_backend)
        ref_s = ref_api.Group(ref_api.single_group(4, **cfg_args)).stream(
            backend=ref_backend)
        ready = np.zeros(port_s.shape, np.int32)
        ready[0, :2] = 200
        report, _ = _drive(port_s, ref_s, [ready], finish_kw)
        if finish_kw:
            assert report.stalled and report.delivered_app_msgs < 4 * 400
        else:
            assert not report.stalled
            assert report.delivered_app_msgs == 4 * 400


def _hetero_domain(api):
    """Topics with 1-3 publishers and 1-4 subscribers over 7 nodes: the
    stack is padded, so the stream runs the masked sweep."""
    d = api.Domain(n_nodes=7)
    for t in range(5):
        n_pub, n_sub = 1 + t % 3, 1 + (2 * t) % 4
        nodes = [(t + i) % 7 for i in range(n_pub + n_sub)]
        d.create_topic(f"topic-{t}", publishers=nodes[:n_pub],
                       subscribers=nodes[n_pub:], sample_size=1024,
                       window=3 + t)
    return d


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("domain", ["many_topic", "hetero"])
def test_bound_domain_streams_per_round_counts(port_backend, ref_backend,
                                               domain):
    """A bursty per-round publish pattern, pushed by topic name, delivers
    exactly what was pushed — identically on both packages."""
    if domain == "many_topic":
        port_d = port_api.many_topic_domain(4, 3, subscribers_per_topic=2,
                                            window=8)
        ref_d = ref_api.many_topic_domain(4, 3, subscribers_per_topic=2,
                                          window=8)
    else:
        port_d, ref_d = _hetero_domain(port_api), _hetero_domain(ref_api)
    port_b = port_d.bind(backend=port_backend, device="cpu")
    ref_b = ref_d.bind(backend=ref_backend)
    rng = np.random.default_rng(7)
    pushed = {t.name: 0 for t in port_d.topics}
    for rnd in range(8):
        counts = {}
        for t in port_d.topics:
            c = rng.integers(0, 3, size=len(t.publishers))
            if c.any():
                counts[t.name] = c
                pushed[t.name] += int(c.sum())
        _assert_views_equal(port_b.push_round(counts),
                            ref_b.push_round(counts))
        assert port_b.round == ref_b.round == rnd + 1
        got_bl, want_bl = port_b.topic_backlogs(), ref_b.topic_backlogs()
        assert got_bl.keys() == want_bl.keys()
        for name in want_bl:
            np.testing.assert_array_equal(got_bl[name], want_bl[name])
    matrix = np.zeros(port_b.stream.shape, np.int32)
    matrix[port_b.gid_of("topic-1"), 0] = 2
    pushed["topic-1"] += 2
    _assert_views_equal(port_b.push_matrix(matrix),
                        ref_b.push_matrix(matrix))
    report, logs = port_b.finish()
    want_report, want_logs = ref_b.finish()
    _assert_reports_equal(report, want_report)
    _assert_logs_equal(logs, want_logs)
    assert not report.stalled
    for name, log in logs.items():
        assert sum(int(a.sum()) for a in log.is_app) == pushed[name]


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_null_send_off_drain_stops_at_the_fixed_point(port_backend,
                                                      ref_backend):
    """Uneven senders with null-send off never quiesce: the drain exits
    at the protocol's fixed point, identically."""
    flags = dataclasses.replace(port_api.SpindleFlags.spindle(),
                                null_send=False)
    ref_flags = dataclasses.replace(ref_api.SpindleFlags.spindle(),
                                    null_send=False)
    cfg_args = dict(n_senders=3, msg_size=512, window=5, n_messages=0)
    port_s = port_api.Group(port_api.single_group(5, flags=flags,
                                                  **cfg_args),
                            device="cpu").stream(backend=port_backend)
    ref_s = ref_api.Group(ref_api.single_group(5, flags=ref_flags,
                                               **cfg_args)).stream(
        backend=ref_backend)
    rounds = []
    for c in ([3, 0, 1], [0, 0, 2], [1, 0, 0]):
        ready = np.zeros(port_s.shape, np.int32)
        ready[0] = c
        rounds.append(ready)
    report, _ = _drive(port_s, ref_s, rounds)
    assert not port_s.quiescent()


def test_epoch_carry_seeds_the_backlog():
    cfg_args = dict(n_senders=2, msg_size=512, window=3, n_messages=0)
    port_g = port_api.Group(port_api.single_group(3, **cfg_args),
                            device="cpu")
    ref_g = ref_api.Group(ref_api.single_group(3, **cfg_args))
    for api, g in ((port_api, port_g), (ref_api, ref_g)):
        g.carry = api.EpochCarry(
            from_epoch=0, cut_seq=(5,), resend=(np.array([4, 1]),),
            stable_apps=(np.array([2, 2]),), app_base=(np.array([2, 2]),))
    port_s, ref_s = port_g.stream("kernel"), ref_g.stream("pallas")
    _assert_views_equal(port_s.view(), ref_s.view())
    _drive(port_s, ref_s, [np.array([[1, 0]], np.int32)])


def test_kernel_stream_sweeps_once_per_round(monkeypatch):
    calls = []
    real = ops.smc_sweep_watermark

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "smc_sweep_watermark", counting)
    bound = port_api.many_topic_domain(4, 3, window=8).bind(
        backend="kernel", device="cpu")
    for _ in range(4):
        bound.push_round({"topic-0": 1, "topic-2": 2})
    assert len(calls) == 4
    report, _ = bound.finish()
    assert len(calls) == report.extras["streamed_rounds"]
    graph = port_api.many_topic_domain(4, 3, window=8).bind(
        backend="graph", device="cpu")
    graph.push_round({"topic-0": 1})
    assert len(calls) == report.extras["streamed_rounds"]


def test_stream_and_bind_validate_inputs():
    cfg = port_api.single_group(3, n_senders=2, n_messages=4)
    with pytest.raises(ValueError, match="unknown backend"):
        port_api.Group(cfg, device="cpu").stream(backend="des")
    stream = port_api.Group(cfg, device="cpu").stream()
    with pytest.raises(ValueError, match="ready must be"):
        stream.step(np.zeros((2, 2), np.int32))
    # absorb is ported (test_absorb_onto_an_epoch_carry_and_its_checks):
    # it checks the traces it installs
    with pytest.raises(ValueError, match="lengths disagree"):
        stream.absorb(stream._states, stream._backlogs, [],
                      [np.zeros(stream.shape)], [], [np.zeros(2)])
    # a view change closes the stream: it refuses further rounds and
    # hands on a stream of the next epoch on the same device
    s2 = stream.reconfigure(port_api.View(vid=1, members=(0, 1),
                                          senders=(0, 1)))
    assert s2.n_members == (2,) and s2.device == stream.device
    with pytest.raises(RuntimeError, match="closed"):
        stream.step(np.zeros(stream.shape, np.int32))
    d = _hetero_domain(port_api)
    bound = d.bind(device="cpu")
    with pytest.raises(ValueError, match="padded lanes"):
        bad = np.zeros(bound.stream.shape, np.int32)
        bad[0, -1] = 1                          # topic-0 has 1 publisher
        bound.push_matrix(bad)
    with pytest.raises(KeyError, match="no-such-topic"):
        bound.push_round({"no-such-topic": 1})
    with pytest.raises(ValueError, match="publishers"):
        bound.push_round({"topic-0": [1, 1]})
    new_bound, old_report, old_logs = bound.reconfigure(
        port_api.View(vid=1, members=tuple(range(1, 7)),
                      senders=tuple(range(1, 7))))
    assert old_report.extras["view_change"]["cut_seq"]
    assert set(old_logs) <= {t.name for t in d.topics}
    assert [t.name for t in new_bound.domain.topics] == \
        [t.name for t in d.topics]


def test_stream_wants_the_gpu_unless_told():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        port_api.many_topic_domain(4, 3).bind()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_group.Group(port_api.single_group(3)).stream()


def _absorb_source(backend, g, rounds):
    """Step a stream through ``rounds`` ready rows; returns what a fused
    program hands ``absorb``: the final carry, the per-round traces and
    the per-rank enqueued totals."""
    src = g.stream(backend=backend)
    for ready in rounds:
        src.step(ready)
    batches, app_pub, nulls = src.traces()
    enq = np.sum(rounds, axis=0).astype(np.int64)
    return (src._states, src._backlogs, list(batches.swapaxes(0, 1)),
            list(app_pub.swapaxes(0, 1)), list(nulls.swapaxes(0, 1)),
            [enq[gid] for gid in range(enq.shape[0])])


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("domain", ["single", "hetero"])
def test_absorbed_rounds_finish_like_stepped_ones(port_backend, ref_backend,
                                                  domain):
    """Rounds run outside a stream and absorbed into a fresh one finish
    exactly as if ``step`` had streamed them (report, logs, traces,
    watermarks, ``app_publish_index``), and as the reference's absorbed
    stream."""
    rng = np.random.default_rng(11)
    if domain == "single":
        cfg = port_api.single_group(4, n_senders=3, msg_size=1024,
                                    window=3, n_messages=0)
        make = (lambda api: api.Group(cfg, device="cpu") if api is port_api
                else ref_api.Group(ref_api.single_group(
                    4, n_senders=3, msg_size=1024, window=3,
                    n_messages=0)))
    else:
        def make(api):
            d = api.Domain(n_nodes=6)
            d.create_topic("a", publishers=[0, 1, 2], subscribers=[3, 4],
                           window=4)
            d.create_topic("b", publishers=[2], subscribers=[5, 0],
                           window=2)
            kw = {"device": "cpu"} if api is port_api else {}
            return d.group(samples_per_publisher=0, **kw)
    shape = make(port_api).stream(backend=port_backend).shape
    mask = np.zeros(shape, bool)
    for gid, s_g in enumerate(make(port_api).stream(
            backend=port_backend).n_senders):
        mask[gid, :s_g] = True
    rounds = [np.where(mask, rng.integers(0, 3, shape), 0).astype(np.int32)
              for _ in range(7)]
    stepped = make(port_api).stream(backend=port_backend)
    for ready in rounds:
        stepped.step(ready)
    absorbed = make(port_api).stream(backend=port_backend)
    absorbed.absorb(*_absorb_source(port_backend, make(port_api), rounds))
    assert absorbed.rounds == stepped.rounds == len(rounds)
    _assert_streams_equal(absorbed, stepped)
    ref = make(ref_api).stream(backend=ref_backend)
    src = _absorb_source(ref_backend, make(ref_api), rounds)
    ref.absorb(*src)
    got, want, ref_out = absorbed.finish(), stepped.finish(), ref.finish()
    _assert_streams_equal(absorbed, stepped)
    for other in (want, ref_out):
        _assert_reports_equal(got[0], other[0])
        _assert_logs_equal(got[1], other[1])
    _assert_streams_equal(absorbed, ref)


def test_absorb_onto_an_epoch_carry_and_its_checks():
    """A carry-seeded stream takes absorbed rounds on top of its resend
    backlog; absorb refuses a used stream and mis-shaped traces."""
    cfg_args = dict(n_senders=2, msg_size=512, window=3, n_messages=0)
    streams = []
    for _ in range(2):
        g = port_api.Group(port_api.single_group(3, **cfg_args),
                           device="cpu")
        g.carry = port_api.EpochCarry(
            from_epoch=0, cut_seq=(5,), resend=(np.array([4, 1]),),
            stable_apps=(np.array([2, 2]),), app_base=(np.array([2, 2]),))
        streams.append(g.stream("graph"))
    stepped, absorbed = streams
    rounds = [np.array([[1, 0]], np.int32), np.array([[0, 2]], np.int32)]
    src = port_api.Group(port_api.single_group(3, **cfg_args),
                         device="cpu")
    src.carry = stepped.group.carry
    src_stream = src.stream("graph")
    for ready in rounds:
        stepped.step(ready)
        src_stream.step(ready)
    batches, app_pub, nulls = src_stream.traces()
    absorbed.absorb(src_stream._states, src_stream._backlogs,
                    batches.swapaxes(0, 1), app_pub.swapaxes(0, 1),
                    nulls.swapaxes(0, 1), [np.array([1, 2])])
    _assert_streams_equal(absorbed, stepped)
    got, want = absorbed.finish(), stepped.finish()
    _assert_reports_equal(got[0], want[0])
    _assert_logs_equal(got[1], want[1])
    with pytest.raises(RuntimeError, match="no rounds streamed"):
        stepped.absorb(src_stream._states, src_stream._backlogs, [], [], [],
                       [np.zeros(2)])
    fresh = port_api.Group(port_api.single_group(3, **cfg_args),
                           device="cpu").stream("graph")
    with pytest.raises(ValueError, match="lengths disagree"):
        fresh.absorb(src_stream._states, src_stream._backlogs,
                     batches.swapaxes(0, 1), app_pub.swapaxes(0, 1)[:1],
                     nulls.swapaxes(0, 1), [np.zeros(2)])
    with pytest.raises(ValueError, match="shaped"):
        fresh.absorb(src_stream._states, src_stream._backlogs,
                     [np.zeros((1, 2))], [np.zeros((1, 2))],
                     [np.zeros((1, 2))], [np.zeros(2)])
