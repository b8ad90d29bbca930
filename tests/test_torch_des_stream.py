"""The des stream — the numpy round mirror — against the reference's and
the port's device rounds, on the CPU.

``repro_torch.core.desreplay``'s ``sweep_np`` / ``stream_program_np`` /
``batch_states_np`` are held to the reference's numpy mirror and to the
port's torch ``stream_stacked`` on seeded rounds, masked and unmasked;
a ``GroupStream`` on ``des`` to the port's ``graph`` stream and the
reference's ``des`` stream round by round and through cascading and
joining cuts (every epoch's specs, delivery logs, ``EpochCarry`` and
``view_change``); and the planes that stream on ``des`` — ``chaos_soak``,
``ReplicatedEngine`` per round and fused, ``BucketSyncStream`` — to
their ``graph`` runs and the reference's.  Every protocol array is
exact; the report's float fields are exact against the port's ``graph``
stream (the same post-processing on the same traces).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.chaos import FaultSpec as RefFaultSpec
from repro.chaos import chaos_soak as ref_chaos_soak
from repro.core import desreplay as ref_desreplay
from repro.core import sweep as ref_sweep
from repro.core.gradsync import BucketSyncStream as RefBucketSyncStream
from repro.models import layers as ref_layers
from repro_torch import api
from repro_torch.chaos import FaultSpec, chaos_soak
from repro_torch.core import desreplay
from repro_torch.core import group as group_mod
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.gradsync import BucketSyncStream
from test_torch_cut import (THREE_CUTS, _assert_carries_equal,
                            _assert_epochs_equal, _assert_logs_equal,
                            _drive, _hetero_domain, _seeded_cuts,
                            _two_subgroups)
from test_torch_serve import params  # noqa: F401
from test_torch_serve_fused import (_assert_conformant,
                                    _assert_matches_reference, _engines,
                                    _homogeneous_cut, _ref_engines,
                                    _ref_rep, _rep, port_params,  # noqa: F401
                                    ref_params)  # noqa: F401

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

FIELDS = [f.name for f in dataclasses.fields(sweep_mod.SweepState)]
FLOAT_FIELDS = ("throughput_GBps", "mean_latency_us", "p99_latency_us",
                "duration_us", "per_node_throughput")


def _assert_states_equal(got, want, ctx):
    for f in FIELDS:
        a = getattr(got, f)
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(getattr(want, f))
        assert isinstance(getattr(got, f), (np.ndarray, torch.Tensor))
        assert a.dtype == np.int32 and b.dtype == np.int32, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {f}")


def _ref_states(states):
    return ref_sweep.SweepState(**{f: np.asarray(getattr(states, f))
                                   for f in FIELDS})


# ---------------------------------------------------------------------------
# the numpy mirror
# ---------------------------------------------------------------------------

def _stack(masked):
    """(G, N_max, S_max) with per-subgroup (members, senders, window)."""
    if masked:
        return (4, 5, 3), (2, 4, 1), (3, 5, 2)
    return (4, 4), (3, 3), (3, 6)


@pytest.mark.parametrize("null_send", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_mirror_matches_reference_and_torch_rounds(seed, masked,
                                                         null_send):
    """``stream_program_np`` against the reference's and against the
    port's torch ``stream_stacked`` on the CPU, round by round: states,
    backlogs and the three traces, int32 and exact."""
    members, senders, windows = _stack(masked)
    g_n, n_max, s_max = len(members), max(members), max(senders)
    mm = np.arange(n_max)[None, :] < np.asarray(members)[:, None]
    sm = np.arange(s_max)[None, :] < np.asarray(senders)[:, None]
    masks = (mm, sm) if masked else ()
    prog = desreplay.stream_program_np(windows, null_send)
    ref_prog = ref_desreplay.stream_program_np(windows, null_send)
    st = desreplay.batch_states_np(n_max, s_max, g_n)
    ref_st = ref_desreplay.batch_states_np(n_max, s_max, g_n)
    _assert_states_equal(st, ref_st, "init")
    t_st = sweep_mod.batch_states(n_max, s_max, g_n, "cpu")
    _assert_states_equal(t_st, st, "torch init")
    bk = ref_bk = np.zeros((g_n, s_max), np.int32)
    t_bk = torch.zeros((g_n, s_max), dtype=torch.int32)
    t_masks = {} if not masked else dict(
        member_masks=torch.as_tensor(mm), sender_masks=torch.as_tensor(sm))
    rng = np.random.default_rng(seed)
    for rnd in range(14):
        ready = rng.integers(0, 4, size=(g_n, s_max)).astype(np.int32)
        ready = np.where(sm, ready, 0).astype(np.int32)
        if rnd >= 10:
            ready[:] = 0                     # drain rounds
        (st, bk), outs = prog(st, bk, ready.copy(), *masks)
        (ref_st, ref_bk), ref_outs = ref_prog(ref_st, ref_bk, ready.copy(),
                                              *masks)
        (t_st, t_bk), t_outs = sweep_mod.stream_stacked(
            t_st, t_bk, torch.as_tensor(ready),
            windows=torch.as_tensor(np.asarray(windows, np.int32)),
            null_send=null_send, **t_masks)
        ctx = f"round {rnd}"
        _assert_states_equal(st, ref_st, ctx)
        _assert_states_equal(t_st, st, "torch " + ctx)
        for got, want, tw in zip((bk,) + tuple(outs),
                                 (ref_bk,) + tuple(ref_outs),
                                 (t_bk,) + tuple(t_outs)):
            assert isinstance(got, np.ndarray) and got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=ctx)
            np.testing.assert_array_equal(tw.numpy(), got, err_msg=ctx)


@pytest.mark.parametrize("case", range(4))
def test_sweep_np_matches_the_reference(case):
    """One subgroup's ``sweep_np`` / ``step_backlog_np`` with member and
    sender masks, window and null-send variations, against the
    reference's."""
    rng = np.random.default_rng(100 + case)
    n, s = 5, 4
    member_mask = np.arange(n) < 5 - case % 2
    sender_mask = np.arange(s) < 4 - case // 2
    kw = dict(window=int(rng.integers(2, 6)), null_send=case != 3)
    if case:
        kw.update(member_mask=member_mask, sender_mask=sender_mask)
    st = desreplay.batch_states_np(n, s, 1)
    st = sweep_mod.SweepState(**{f: getattr(st, f)[0] for f in FIELDS})
    ref_st = _ref_states(st)
    bk = ref_bk = np.zeros(s, np.int32)
    for rnd in range(10):
        ready = np.where(sender_mask, rng.integers(0, 3, s), 0).astype(
            np.int32)
        (st, bk), outs = desreplay.step_backlog_np(st, bk, ready, **kw)
        (ref_st, ref_bk), ref_outs = ref_desreplay.step_backlog_np(
            ref_st, ref_bk, ready, **kw)
        _assert_states_equal(st, ref_st, f"round {rnd}")
        for got, want in zip((bk,) + tuple(outs),
                             (ref_bk,) + tuple(ref_outs)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.asarray(want).dtype
        new, batch = desreplay.sweep_np(st, ready, **kw)
        ref_new, ref_batch = ref_desreplay.sweep_np(ref_st, ready, **kw)
        _assert_states_equal(new, ref_new, f"sweep {rnd}")
        np.testing.assert_array_equal(batch, ref_batch)


# ---------------------------------------------------------------------------
# des streams: round by round, and through cuts
# ---------------------------------------------------------------------------

def _mirror_cfg(pkg):
    s1 = pkg.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 2), window=3,
                          msg_size=512, n_messages=10)
    s2 = pkg.SubgroupSpec(members=(2, 3, 4, 5, 6), senders=(3, 4, 5, 6),
                          window=5, msg_size=128, n_messages=10)
    return pkg.GroupConfig(members=tuple(range(7)), subgroups=(s1, s2))


def test_des_stream_matches_graph_and_reference_rounds(monkeypatch):
    """A des stream's views equal the graph stream's and the reference's
    des stream's every round; its finish report equals the graph
    stream's exactly, floats included, and it never calls the torch
    round nor holds a tensor."""
    cfg = _mirror_cfg(api)
    streams = {be: api.Group(cfg, device="cpu").stream(backend=be)
               for be in ("graph", "des")}
    ref_stream = ref_api.Group(_mirror_cfg(ref_api)).stream(backend="des")
    des = streams["des"]
    assert des._numpy and not streams["graph"]._numpy
    assert all(isinstance(m, np.ndarray) for m in des._masks)
    torch_round = sweep_mod.stream_stacked
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return torch_round(*a, **k)

    monkeypatch.setattr(sweep_mod, "stream_stacked", counted)
    rng = np.random.default_rng(21)
    for _ in range(10):
        ready = rng.integers(0, 3, size=(2, 4)).astype(np.int32)
        ready[0, 2:] = 0
        views = [s.step(ready.copy()) for s in (streams["graph"], des,
                                                ref_stream)]
        for v in views[1:]:
            for f in ("round", "delivered_num", "published", "backlog",
                      "app_pub", "nulls"):
                np.testing.assert_array_equal(getattr(views[0], f),
                                              getattr(v, f), err_msg=f)
    n_graph = len(calls)
    assert n_graph == 10                     # the graph stream's rounds
    for f in FIELDS:
        assert isinstance(getattr(des._states, f), np.ndarray)
    ra, la = streams["graph"].finish()
    rb, lb = des.finish()
    rr, lr = ref_stream.finish()
    assert len(calls) - n_graph == ra.extras["streamed_rounds"] - 10
    assert rb.backend == "des" and not rb.stalled
    da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
    for d in (da, db):
        d.pop("backend")
        d["extras"].pop("wall_s")
    assert da == db
    for f in ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled"):
        assert getattr(rb, f) == getattr(rr, f), f
    for gid in la:
        for log in (lb[gid], lr[gid]):
            assert log.delivered_seq == la[gid].delivered_seq
            for x, y in zip(log.is_app, la[gid].is_app, strict=True):
                np.testing.assert_array_equal(x, y)


def _assert_floats_equal(got, want, ctx):
    for e, (a, b) in enumerate(zip(got, want)):
        for f in FLOAT_FIELDS:
            assert getattr(a["report"], f) == getattr(b["report"], f), \
                (ctx, e, f)


@pytest.mark.parametrize("seed", [5, 31])
def test_des_cut_schedules_match_reference_and_graph(seed):
    """Seeded suspicion/join schedules (``tests/test_viewchange.py``'s
    ``test_cut_schedules_bit_identical_graph_pallas_des``): every epoch of
    the port's des stream equals the reference's des stream's and the
    port's graph stream's."""
    cuts = _seeded_cuts(seed)
    members0 = [0, 1, 2, 3, 4]
    got, _, _ = _drive(api, "des", _two_subgroups(api), 10, cuts, seed,
                       members0)
    graph, _, _ = _drive(api, "graph", _two_subgroups(api), 10, cuts, seed,
                         members0)
    want, _, _ = _drive(ref_api, "des", _two_subgroups(ref_api), 10, cuts,
                        seed, members0)
    _assert_epochs_equal(got, want, f"seed {seed} vs reference des")
    _assert_epochs_equal(got, graph, f"seed {seed} vs graph")
    _assert_floats_equal(got, graph, f"seed {seed}")


@pytest.mark.parametrize("timeline", ["three_cuts", "cascade"])
def test_des_three_cut_and_cascading_timelines(timeline):
    """The three-cut timeline (a failure, a join, a failure) and a
    cascade folded into one cut followed by a join, on des against the
    reference's des and the port's graph."""
    cuts, n_rounds, seed = {
        "three_cuts": (THREE_CUTS, 11, 101),
        "cascade": ({3: [("cascade", [3, 0])], 6: [("join", 7)]}, 9, 7),
    }[timeline]
    members0 = [0, 1, 2, 3, 4]
    got, stream, _ = _drive(api, "des", _two_subgroups(api), n_rounds,
                            cuts, seed, members0)
    assert stream._numpy and stream.carry is not None
    graph, _, _ = _drive(api, "graph", _two_subgroups(api), n_rounds, cuts,
                         seed, members0)
    want, _, _ = _drive(ref_api, "des", _two_subgroups(ref_api), n_rounds,
                        cuts, seed, members0)
    _assert_epochs_equal(got, want, f"{timeline} vs reference des")
    _assert_epochs_equal(got, graph, f"{timeline} vs graph")
    _assert_floats_equal(got, graph, timeline)


def test_des_consecutive_cuts_with_zero_rounds_between():
    """Two cuts with no round between them (``tests/test_viewchange.py``'s
    carry of a carry): the middle epoch trims to -1, carries the first
    resend verbatim, and the drained third epoch lands everything once;
    equal to the reference's des stream and the port's graph stream."""
    out = {}
    for name, pkg, backend in (("des", api, "des"), ("graph", api, "graph"),
                               ("ref", ref_api, "des")):
        spec = pkg.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1, 2),
                                msg_size=512, window=4, n_messages=0)
        cfg = pkg.GroupConfig(members=(0, 1, 2, 3, 4, 5),
                              subgroups=(spec,))
        ms = pkg.MembershipService(cfg.members)
        g = pkg.Group(cfg, device="cpu") if pkg is api else pkg.Group(cfg)
        stream = g.stream(backend=backend)
        rng = np.random.default_rng(17)
        enq = np.zeros(3, np.int64)
        for _ in range(4):
            ready = np.zeros(stream.shape, np.int32)
            ready[0, :3] = rng.integers(0, 3, 3)
            enq += ready[0, :3]
            stream.step(ready)
        carries, groups = [], []
        for node in (4, 5):
            ms.suspect(0, node)
            groups.append(stream.group)
            _, stream = ms.reconfigure_stream(stream, {})
            carries.append(stream.carry)
        report, logs = stream.finish()
        assert not report.stalled
        out[name] = (carries, groups, logs, enq)
    carries, groups, logs, enq = out["des"]
    c1, c2 = carries
    assert groups[1].last_report.extras["view_change"]["cut_seq"][0] == -1
    np.testing.assert_array_equal(c1.app_base[0] + c1.resend[0], enq)
    np.testing.assert_array_equal(c2.resend[0], c1.resend[0])
    np.testing.assert_array_equal(c2.app_base[0], c1.app_base[0])
    for other in ("graph", "ref"):
        o_carries, o_groups, o_logs, _ = out[other]
        for a, b in zip(carries, o_carries):
            assert a.cut_seq == b.cut_seq and a.from_epoch == b.from_epoch
            for f in ("resend", "stable_apps", "app_base"):
                for x, y in zip(getattr(a, f), getattr(b, f)):
                    np.testing.assert_array_equal(x, y, err_msg=other)
        for ga, gb in zip(groups, o_groups):
            assert set(ga.delivery_logs) == set(gb.delivery_logs)
            for gid, log in ga.delivery_logs.items():
                assert log.delivered_seq == \
                    gb.delivery_logs[gid].delivered_seq, other
        assert logs[0].delivered_seq == o_logs[0].delivered_seq, other
        for x, y in zip(logs[0].is_app, o_logs[0].is_app, strict=True):
            np.testing.assert_array_equal(x, y, err_msg=other)
    for node in (0, 1, 2, 3):
        per = np.zeros(3, np.int64)
        for ep in (groups[0].delivery_logs[0], logs[0]):
            for rank, _, _ in ep.sequence(node):
                per[rank] += 1
        np.testing.assert_array_equal(per, enq, err_msg=f"node {node}")


def test_bound_domain_on_des_through_a_cut():
    """``Domain.bind(backend="des")`` on a padded, masked domain through
    ``BoundDomain.reconfigure`` with two nodes failing: every report
    field, the per-topic logs and the carry equal the port's graph
    binding's and the reference's des binding's."""
    out = {}
    for name, pkg, backend in (("des", api, "des"), ("graph", api, "graph"),
                               ("ref", ref_api, "des")):
        kw = {"device": "cpu"} if pkg is api else {}
        bound = _hetero_domain(pkg).bind(backend=backend, **kw)
        rng = np.random.default_rng(3)
        records = []

        def push(b, n):
            for _ in range(n):
                b.push_round({t.name: rng.integers(0, 3, len(t.publishers))
                              for t in b.domain.topics})

        push(bound, 5)
        ms = pkg.MembershipService(range(7))
        ms.suspect(0, 2)
        ms.suspect(0, 5)
        new_bound, old_report, old_logs = bound.reconfigure(
            ms.propose_and_install({}))
        records.append((old_report, old_logs))
        push(new_bound, 4)
        records.append(new_bound.finish())
        out[name] = (records, new_bound)
    got, bd = out["des"]
    assert bd.stream._numpy and bd.stream.backend.name == "des"
    for other in ("graph", "ref"):
        want, bw = out[other]
        _assert_carries_equal(bd.stream.carry, bw.stream.carry, other)
        for (rg, lg), (rw, lw) in zip(got, want):
            for f in ("delivered_app_msgs", "delivered_null_msgs",
                      "nulls_sent", "rdma_writes", "rounds", "stalled"):
                assert getattr(rg, f) == getattr(rw, f), (other, f)
            if other == "graph":
                for f in FLOAT_FIELDS:
                    assert getattr(rg, f) == getattr(rw, f), f
            _assert_logs_equal(lg, lw, other)


def test_des_loop_refuses_streaming():
    g = api.Group(api.single_group(3, n_senders=2, n_messages=4),
                  device="cpu")
    report = g.run(backend="des-loop")
    assert report.backend == "des-loop"
    assert report.delivered_app_msgs == 2 * 4 * 3
    with pytest.raises(ValueError, match="graph/kernel/des"):
        g.stream(backend="des-loop")


def test_absorb_lands_device_rounds_in_numpy():
    """Rounds run on the torch round (as a fused program does) and
    absorbed into a des stream land as int32 numpy state; its finish
    equals the graph stream that streamed them."""
    cfg = _mirror_cfg(api)
    src = api.Group(cfg, device="cpu").stream(backend="graph")
    rng = np.random.default_rng(4)
    for _ in range(6):
        ready = rng.integers(0, 3, size=(2, 4)).astype(np.int32)
        ready[0, 2:] = 0
        src.step(ready)
    des = api.Group(cfg, device="cpu").stream(backend="des")
    batches, app_pub, nulls = src.traces()
    des.absorb(src._states, src._backlogs, list(batches.transpose(1, 0, 2)),
               list(app_pub.transpose(1, 0, 2)),
               list(nulls.transpose(1, 0, 2)), src._enqueued)
    for f in FIELDS:
        x = getattr(des._states, f)
        assert isinstance(x, np.ndarray) and x.dtype == np.int32
    assert isinstance(des._backlogs, np.ndarray)
    ra, _ = src.finish()
    rb, _ = des.finish()
    for f in ("delivered_app_msgs", "nulls_sent", "rounds", "stalled") + \
            FLOAT_FIELDS:
        assert getattr(ra, f) == getattr(rb, f), f


# ---------------------------------------------------------------------------
# the planes on des: chaos soak, serve, gradsync
# ---------------------------------------------------------------------------

STREAM_SPEC = dict(rounds=24, suspect_rate=0.25, cascade_prob=0.5,
                   join_rate=0.15, stall_rate=0.15)


def _chaos_group(pkg):
    a = pkg.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1, 2),
                         msg_size=512, window=4, n_messages=0)
    b = pkg.SubgroupSpec(members=(1, 2, 3), senders=(1, 2), msg_size=256,
                         window=4, n_messages=0)
    cfg = pkg.GroupConfig(members=(0, 1, 2, 3, 4), subgroups=(a, b))
    return pkg.Group(cfg, device="cpu") if pkg is api else pkg.Group(cfg)


def _report(rep):
    out = dataclasses.asdict(rep)
    out.pop("backend")
    return out


@pytest.mark.parametrize("seed", [11, 23])
def test_chaos_soak_on_des_matches_the_reference(seed):
    got = chaos_soak(_chaos_group(api), FaultSpec(**STREAM_SPEC), seed=seed,
                     backend="des")
    want = ref_chaos_soak(_chaos_group(ref_api), RefFaultSpec(**STREAM_SPEC),
                          seed=seed, backend="des")
    graph = chaos_soak(_chaos_group(api), FaultSpec(**STREAM_SPEC),
                       seed=seed, backend="graph")
    assert got.backend == "des" and got.views_installed >= 1
    assert _report(got) == _report(want) == _report(graph)


def test_gradsync_stream_on_des_matches_the_reference():
    spec = dict(rounds=20, suspect_rate=0.2, cascade_prob=0.5,
                join_rate=0.2, stall_rate=0.1)
    gs = BucketSyncStream([0, 1, 2, 3], n_buckets=2, window=6,
                          backend="des", device="cpu")
    assert gs._stream._numpy
    got = chaos_soak(gs, FaultSpec(**spec), seed=23)
    want = ref_chaos_soak(
        RefBucketSyncStream([0, 1, 2, 3], n_buckets=2, window=6,
                            backend="des"), RefFaultSpec(**spec), seed=23)
    assert got.backend == "des" and got.extras["applied"]
    assert _report(got) == _report(want)


def test_replicated_engine_on_des_per_round_and_fused(monkeypatch,
                                                      port_params,
                                                      ref_params):
    """``ReplicatedEngine(backend="des")``: the per-round loop equals the
    graph loop (tokens, traces, logs, every report field), the fused run
    equals the per-round des loop, also through a homogeneous cut, and
    both equal the reference's fused des run."""
    engines = _engines(port_params, 3)
    rep_g = _rep(engines, "graph", reqs=4)
    r_g = rep_g.run()
    rep_d = _rep(engines, "des", reqs=4)
    r_d = rep_d.run()
    assert rep_d.completed() == rep_g.completed()
    for f in ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled") + FLOAT_FIELDS:
        assert getattr(r_d, f) == getattr(r_g, f), f
    for name in ("admit_rounds", "finish_rounds", "free_rounds"):
        assert getattr(rep_d, name) == getattr(rep_g, name), name
    rep_f = _rep(engines, "des", reqs=4)
    r_f = rep_f.run(fused=True)
    _assert_conformant(rep_d, r_d, rep_f, r_f)
    rep_uc = _rep(engines, "des", reqs=4)
    r_uc = rep_uc.run(fail_at=_homogeneous_cut(rep_uc))
    rep_fc = _rep(engines, "des", reqs=4)
    r_fc = rep_fc.run(fail_at=_homogeneous_cut(rep_fc), fused=True)
    assert r_fc.extras["serve"]["fused_epochs"] == 2
    _assert_conformant(rep_uc, r_uc, rep_fc, r_fc)
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_rep = _ref_rep(_ref_engines(ref_params, 3), "des", reqs=4)
    r_ref = ref_rep.run(fail_at=_homogeneous_cut(ref_rep), fused=True)
    _assert_matches_reference(rep_fc, r_fc, ref_rep, r_ref)
    assert group_mod.get_backend("des", "cpu").stream_numpy
