"""The port's virtual-synchrony cut against the reference's, on the CPU.

``Group.reconfigure`` (queued explicit sends), ``GroupStream.reconfigure``
driven through ``MembershipService.reconfigure_stream`` (the timelines of
``tests/test_viewchange.py``: seeded cut schedules, the three-cut
timeline, consecutive cuts with no round between them, the eight-view
soak with no fresh-epoch restart), ``BoundDomain.reconfigure`` on a
heterogeneous domain and ``Group.run`` on a carried Group.  Port
``"graph"`` and ``"kernel"`` on ``device="cpu"`` are held against the
reference's ``"graph"`` (and ``"pallas"``, its Pallas kernel in
interpret mode, on the three-cut timeline).  The tolerance is exact for
every protocol array: each epoch's subgroup specs, delivery logs (the
delivered seq of every member and every sender's nullness log), the
``EpochCarry`` (``from_epoch``, ``cut_seq``, ``resend``,
``stable_apps``, ``app_base``), ``extras["view_change"]`` and the
integer report fields.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import api as ref_api
from repro_torch import api as port_api
from repro_torch.kernels import ops

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled")
PORT_BACKENDS = ("graph", "kernel")


def _open(api, cfg, backend):
    if api is port_api:
        return api.Group(cfg, device="cpu").stream(backend=backend)
    return api.Group(cfg).stream(backend=backend)


def _two_subgroups(api):
    """Nodes 1 and 2 never fail, so both subgroups survive every
    schedule (the cut test group of ``tests/test_viewchange.py``)."""
    spec_a = api.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1, 2),
                              msg_size=512, window=4, n_messages=0)
    spec_b = api.SubgroupSpec(members=(1, 2, 3), senders=(1, 2),
                              msg_size=256, window=4, n_messages=0)
    return api.GroupConfig(members=(0, 1, 2, 3, 4),
                           subgroups=(spec_a, spec_b))


def _specs(specs):
    """Subgroup specs as plain tuples (each package has its own class)."""
    return tuple(dataclasses.astuple(s) for s in specs)


def _epoch(old_group, alive, carry):
    report = old_group.last_report
    return {"specs": _specs(old_group.cfg.subgroups),
            "subgroups": old_group.cfg.subgroups,
            "epoch": old_group.cfg.epoch, "logs": old_group.delivery_logs,
            "alive": alive, "carry": carry, "report": report,
            "view_change": report.extras.get("view_change")
            if report is not None else None}


def _drive(api, backend, cfg, n_rounds, cuts, seed, members0,
           ready_fn=None):
    """Stream ``n_rounds`` rounds of seeded traffic; at round r in
    ``cuts`` apply its events (``("fail", node)``, ``("join", node)``,
    ``("cascade", [node, ...])`` = waves landing during the wedge) and
    cross the cut.  Returns the epochs, oldest first, the last one the
    drained final epoch."""
    rng = np.random.default_rng(seed)
    ms = api.MembershipService(members0)
    stream = _open(api, cfg, backend)
    failed, epochs, enqueued = set(), [], {}
    for rnd in range(n_rounds):
        ready = np.zeros(stream.shape, np.int32)
        for g, spec in enumerate(stream.group.cfg.subgroups):
            for rank, node in enumerate(spec.senders):
                if node not in failed:
                    c = int(rng.integers(0, 3)) if ready_fn is None \
                        else ready_fn(rng, g, rank)
                    ready[g, rank] = c
                    enqueued[(g, node)] = enqueued.get((g, node), 0) + c
        stream.step(ready)
        if rnd not in cuts:
            continue
        waves = []
        for kind, node in cuts[rnd]:
            if kind == "fail":
                ms.suspect(members0[1], node)
                failed.add(node)
            elif kind == "join":
                ms.request_join(node)
            else:                        # the first wave, then the rest
                ms.suspect(members0[1], node[0])
                waves = [[n] for n in node[1:]]
                failed.update(node)

        def during(svc, attempt, waves=waves):
            if attempt < len(waves):
                for n in waves[attempt]:
                    svc.suspect(members0[1], n)

        old = stream.group
        view, stream = ms.reconfigure_stream(
            stream, {}, during_wedge=during if waves else None)
        assert old.last_report is not None
        epochs.append(_epoch(old, set(view.members), stream.carry))
    report, logs = stream.finish()
    assert not report.stalled
    epochs.append(_epoch(stream.group, set(stream.group.cfg.members),
                         None))
    return epochs, stream, enqueued


def _assert_logs_equal(got, want, ctx):
    assert set(got) == set(want), ctx
    for gid in want:
        g, w = got[gid], want[gid]
        assert g.n_senders == w.n_senders, ctx
        assert g.delivered_seq == w.delivered_seq, (ctx, gid)
        assert len(g.is_app) == len(w.is_app), ctx
        for x, y in zip(g.is_app, w.is_app):
            np.testing.assert_array_equal(x, np.asarray(y),
                                          err_msg=f"{ctx} {gid}")


def _assert_carries_equal(got, want, ctx):
    assert (got is None) == (want is None), ctx
    if want is None:
        return
    assert got.from_epoch == want.from_epoch, ctx
    assert got.cut_seq == want.cut_seq, ctx
    assert got.total_resend() == want.total_resend(), ctx
    for field in ("resend", "stable_apps", "app_base"):
        a, b = getattr(got, field), getattr(want, field)
        assert len(a) == len(b), (ctx, field)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"{ctx} {field}")


def _assert_epochs_equal(got, want, ctx=""):
    assert len(got) == len(want), ctx
    for e, (a, b) in enumerate(zip(got, want)):
        c = f"{ctx} epoch {e}"
        assert a["specs"] == b["specs"] and a["alive"] == b["alive"], c
        assert a["epoch"] == b["epoch"], c
        _assert_logs_equal(a["logs"], b["logs"], c)
        _assert_carries_equal(a["carry"], b["carry"], c)
        for f in INT_FIELDS:
            assert getattr(a["report"], f) == getattr(b["report"], f), \
                (c, f)
        assert a["report"].extras["streamed_rounds"] == \
            b["report"].extras["streamed_rounds"], c
        va, vb = a["view_change"], b["view_change"]
        assert (va is None) == (vb is None), c
        if vb is not None:
            assert va["cut_seq"] == vb["cut_seq"], c
            assert va["resend_msgs"] == vb["resend_msgs"], c
            sa, sb = va["stable_apps_by_old_rank"], \
                vb["stable_apps_by_old_rank"]
            assert set(sa) == set(sb), c
            for g in sb:
                np.testing.assert_array_equal(sa[g], sb[g], err_msg=c)


# ---------------------------------------------------------------------------
# Group.reconfigure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_group_reconfigure_carries_queued_explicit_sends(port_backend):
    """Queued-but-never-sent messages survive the view change remapped to
    the surviving sender ranks; a failed sender's queue dies with it."""
    groups = {}
    for name, api in (("port", port_api), ("ref", ref_api)):
        spec = api.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1, 2),
                                msg_size=256, window=8, n_messages=5)
        cfg = api.GroupConfig(members=(0, 1, 2, 3), subgroups=(spec,))
        base = api.Group(cfg, device="cpu") if api is port_api \
            else api.Group(cfg)
        base.subgroup(0).send(sender=0, n=4)
        base.subgroup(0).send(sender=2, n=6)       # sender 2 will fail
        seen = []
        base.subgroup(0).on_delivery(lambda m, d, seen=seen:
                                     seen.append((m, d.seq)))
        g2 = base.reconfigure(api.View(vid=1, members=(0, 1, 3),
                                       senders=(0, 1, 3)))
        assert g2.cfg.epoch == 1
        g2.run(backend=port_backend if api is port_api else "graph")
        groups[name] = (g2, seen)
    (gp, seen_p), (gr, seen_r) = groups["port"], groups["ref"]
    np.testing.assert_array_equal(gp._explicit[0], [4, 0])
    np.testing.assert_array_equal(gp._explicit[0], gr._explicit[0])
    assert gp._gid_map == gr._gid_map
    assert gp._sender_maps == gr._sender_maps
    assert _specs(gp.cfg.subgroups) == _specs(gr.cfg.subgroups)
    assert gp.cfg.members == gr.cfg.members
    assert gp.device == groups["port"][0].device
    assert gp.last_report.delivered_app_msgs == 3 * 4
    for f in INT_FIELDS:
        assert getattr(gp.last_report, f) == getattr(gr.last_report, f), f
    _assert_logs_equal(gp.delivery_logs, gr.delivery_logs, "run")
    assert seen_p == seen_r and len(seen_p) == 3 * 4


def test_group_reconfigure_drops_dead_subgroups_and_keeps_a_silent_sender():
    out = []
    for api in (port_api, ref_api):
        a = api.SubgroupSpec(members=(0, 1), senders=(0, 1), msg_size=64,
                             window=4, n_messages=2)
        b = api.SubgroupSpec(members=(2, 3), senders=(2,), msg_size=64,
                             window=4, n_messages=2)
        c = api.SubgroupSpec(members=(3, 4), senders=(4,), msg_size=64,
                             window=4, n_messages=2)
        pats = (((2, 4), api.SenderPattern(active=False)),
                ((1, 2), api.SenderPattern(n_messages=1)))
        cfg = api.GroupConfig(members=(0, 1, 2, 3, 4),
                              subgroups=(a, b, c), patterns=pats)
        g = api.Group(cfg, device="cpu") if api is port_api \
            else api.Group(cfg)
        g2 = g.reconfigure(api.View(vid=1, members=(2, 3),
                                    senders=(2, 3)))
        out.append((g2.cfg.subgroups, g2.cfg.patterns, g2._gid_map,
                    g2._sender_maps, g2.cfg.epoch))
        out[-1] = (_specs(out[-1][0]),
                   tuple((k, dataclasses.astuple(p)) for k, p in
                         out[-1][1])) + out[-1][2:]
    assert out[0] == out[1]
    specs, patterns, gid_map, _, _ = out[0]
    assert gid_map == {1: 0, 2: 1} and specs[1][1] == (3,)
    assert [key for key, _ in patterns] == [(0, 2)]   # node 4's went


# ---------------------------------------------------------------------------
# GroupStream.reconfigure on the timelines of tests/test_viewchange.py
# ---------------------------------------------------------------------------

_EVENTS = (("fail", 3), ("fail", 0), ("join", 6))


def _seeded_cuts(seed):
    """test_viewchange's ``_drive_schedule``: two of three events at two
    distinct rounds in 2..8."""
    rng = np.random.default_rng(seed)
    events = [_EVENTS[i] for i in rng.permutation(3)[:2]]
    rounds = sorted(rng.choice(np.arange(2, 9), size=2, replace=False))
    return {int(r): [e] for r, e in zip(rounds, events)}


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
@pytest.mark.parametrize("seed", [5, 11, 23, 31, 47])
def test_seeded_cut_schedules_match_the_reference(port_backend, seed):
    """Every epoch bit-identical to the reference's graph stream, and the
    cut delivers everywhere or nowhere: every surviving member of an
    epoch has the same log, each epoch delivers exactly its stable
    prefix, and every message of a live sender lands exactly once."""
    cuts = _seeded_cuts(seed)
    cfg = _two_subgroups(port_api)
    got, _, enqueued = _drive(port_api, port_backend, cfg, 10, cuts, seed,
                              [0, 1, 2, 3, 4])
    want, _, _ = _drive(ref_api, "graph", _two_subgroups(ref_api), 10,
                        cuts, seed, [0, 1, 2, 3, 4])
    _assert_epochs_equal(got, want, f"seed {seed}")
    failed = {n for evs in cuts.values() for k, n in evs if k == "fail"}
    delivered = {}
    for e, ep in enumerate(got):
        for gid, spec in enumerate(ep["subgroups"]):
            log = ep["logs"][gid]
            survivors = [m for m in spec.members if m in ep["alive"]]
            seqs = [log.sequence(m) for m in survivors]
            assert all(s == seqs[0] for s in seqs[1:]), (seed, e, gid)
            per_rank = {}
            for rank, _, _ in seqs[0]:
                per_rank[rank] = per_rank.get(rank, 0) + 1
            for rank, c in per_rank.items():
                key = (gid, spec.senders[rank])
                delivered[key] = delivered.get(key, 0) + c
            if ep["carry"] is not None:
                stable = ep["view_change"]["stable_apps_by_old_rank"][gid]
                assert [per_rank.get(r, 0) for r in range(len(stable))] \
                    == list(stable), (seed, e, gid)
    for key, total in enqueued.items():
        got_n = delivered.get(key, 0)
        assert got_n <= total if key[1] in failed else got_n == total, \
            (seed, key)


THREE_CUTS = {2: [("fail", 3)], 5: [("join", 6)], 8: [("fail", 0)]}


@pytest.mark.parametrize("port_backend,ref_backend",
                         [("graph", "graph"), ("kernel", "graph"),
                          ("kernel", "pallas")])
def test_three_cut_timeline(port_backend, ref_backend):
    got, _, _ = _drive(port_api, port_backend, _two_subgroups(port_api),
                       11, THREE_CUTS, 101, [0, 1, 2, 3, 4])
    want, _, _ = _drive(ref_api, ref_backend, _two_subgroups(ref_api), 11,
                        THREE_CUTS, 101, [0, 1, 2, 3, 4])
    assert len(got) == 4                     # 3 cuts + the drained epoch
    assert [e["epoch"] for e in got] == [0, 1, 2, 3]
    _assert_epochs_equal(got, want, ref_backend)


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_cascading_cut_folds_into_one_view(port_backend):
    """Suspicions landing during the wedge fold into one cut over the
    final survivors."""
    cuts = {3: [("cascade", [3, 0])], 6: [("join", 7)]}
    got, stream, _ = _drive(port_api, port_backend,
                            _two_subgroups(port_api), 9, cuts, 7,
                            [0, 1, 2, 3, 4])
    want, _, _ = _drive(ref_api, "graph", _two_subgroups(ref_api), 9,
                        cuts, 7, [0, 1, 2, 3, 4])
    _assert_epochs_equal(got, want, "cascade")
    assert got[0]["alive"] == {1, 2, 4}


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_consecutive_cuts_with_zero_rounds_between(port_backend):
    """The second epoch opens and closes without a round: its trim is the
    -1 floor, nothing goes stable, the first carry's resend set carries
    over verbatim and ``app_base`` stays put; the third epoch drains
    everything exactly once."""
    out = {}
    for name, api, backend in (("port", port_api, port_backend),
                               ("ref", ref_api, "graph")):
        spec = api.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1, 2),
                                msg_size=512, window=4, n_messages=0)
        cfg = api.GroupConfig(members=(0, 1, 2, 3, 4, 5),
                              subgroups=(spec,))
        ms = api.MembershipService(cfg.members)
        stream = _open(api, cfg, backend)
        rng = np.random.default_rng(17)
        enq = np.zeros(3, np.int64)
        for _ in range(4):
            ready = np.zeros(stream.shape, np.int32)
            ready[0, :3] = rng.integers(0, 3, 3)
            enq += ready[0, :3]
            stream.step(ready)
        epochs = []
        for node in (4, 5):
            ms.suspect(0, node)
            old = stream.group
            view, stream = ms.reconfigure_stream(stream, {})
            epochs.append(_epoch(old, set(view.members), stream.carry))
        report, _ = stream.finish()
        assert not report.stalled
        epochs.append(_epoch(stream.group, set(view.members), None))
        out[name] = (epochs, enq)
    (got, enq), (want, _) = out["port"], out["ref"]
    _assert_epochs_equal(got, want, "carry of a carry")
    c1, c2 = got[0]["carry"], got[1]["carry"]
    assert got[1]["view_change"]["cut_seq"][0] == -1
    np.testing.assert_array_equal(c1.app_base[0] + c1.resend[0], enq)
    np.testing.assert_array_equal(c2.stable_apps[0], np.zeros(3))
    np.testing.assert_array_equal(c2.resend[0], c1.resend[0])
    np.testing.assert_array_equal(c2.app_base[0], c1.app_base[0])
    assert got[1]["logs"] == {}                # no rounds: no logs
    for node in (0, 1, 2, 3):
        per = np.zeros(3, np.int64)
        for ep in (got[0], got[2]):
            for rank, _, _ in ep["logs"][0].sequence(node):
                per[rank] += 1
        np.testing.assert_array_equal(per, enq, err_msg=f"node {node}")


def _count_sweeps(monkeypatch):
    calls = []
    real = ops.smc_sweep_watermark

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "smc_sweep_watermark", counting)
    return calls


def test_eight_view_soak_keeps_one_sweep_a_round(monkeypatch):
    """Eight consecutive view changes under continuous traffic: nodes 4
    and 5 sit outside every subgroup, so each cut rolls the epoch without
    re-shaping the stack.  Every epoch equals the reference's; the kernel
    receive runs once per streamed round in every epoch on the same
    padded shape (no fresh-epoch restart); ``app_base`` is monotone and
    advances by exactly each epoch's stable delta; every message is
    delivered exactly once."""
    calls = _count_sweeps(monkeypatch)
    out = {}
    for name, api, backend in (("port", port_api, "kernel"),
                               ("ref", ref_api, "graph")):
        spec_a = api.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1),
                                  msg_size=512, window=4, n_messages=0)
        spec_b = api.SubgroupSpec(members=(0, 1, 2), senders=(0,),
                                  msg_size=256, window=4, n_messages=0)
        cfg = api.GroupConfig(members=(0, 1, 2, 3, 4, 5),
                              subgroups=(spec_a, spec_b))
        ms = api.MembershipService(cfg.members)
        stream = _open(api, cfg, backend)
        rng = np.random.default_rng(99)
        enqueued = np.zeros((2, 2), np.int64)
        epochs, shapes, sweeps = [], [], []
        for v in range(8):
            n0 = len(calls)
            for _ in range(3):
                ready = np.zeros(stream.shape, np.int32)
                for g_, s_ in ((0, 0), (0, 1), (1, 0)):
                    c = int(rng.integers(0, 3))
                    ready[g_, s_] = c
                    enqueued[g_, s_] += c
                stream.step(ready)
            sweeps.append(len(calls) - n0)
            shapes.append((stream.n_max, stream.s_max, stream.shape))
            if v % 2 == 0:
                ms.suspect(0, 4)
            else:
                ms.request_join(4)
            old = stream.group
            view, stream = ms.reconfigure_stream(stream, {})
            assert view.vid == v + 1
            epochs.append(_epoch(old, set(view.members), stream.carry))
        report, _ = stream.finish()
        assert not report.stalled
        epochs.append(_epoch(stream.group, set(view.members), None))
        out[name] = (epochs, enqueued, shapes, sweeps)
    (got, enqueued, shapes, sweeps), (want, _, _, _) = \
        out["port"], out["ref"]
    _assert_epochs_equal(got, want, "eight views")
    assert sweeps == [3] * 8 and len(set(shapes)) == 1
    prev = [np.zeros(2, np.int64), np.zeros(1, np.int64)]
    for ep in got[:-1]:
        for gid in (0, 1):
            base = ep["carry"].app_base[gid]
            np.testing.assert_array_equal(
                base, prev[gid] + ep["carry"].stable_apps[gid])
            prev[gid] = base
    for gid, spec in enumerate(got[-1]["subgroups"]):
        for node in spec.members:
            per_rank = np.zeros(len(spec.senders), np.int64)
            for ep in got:
                log = ep["logs"].get(gid)
                for rank, _, _ in (log.sequence(node) if log else ()):
                    per_rank[rank] += 1
            np.testing.assert_array_equal(
                per_rank, enqueued[gid, : len(spec.senders)])


def test_same_padded_shape_cut_keeps_the_round(monkeypatch):
    """A cut that re-shapes one subgroup inside an unchanged padded
    (G, N_max, S_max) stack keeps one kernel receive a round on the same
    shape, and the closed stream refuses further use."""
    calls = _count_sweeps(monkeypatch)
    spec_a = port_api.SubgroupSpec(members=(0, 1, 2, 3), senders=(0, 1),
                                   msg_size=512, window=8, n_messages=12)
    spec_b = port_api.SubgroupSpec(members=(0, 1, 4), senders=(0,),
                                   msg_size=256, window=8, n_messages=3)
    cfg = port_api.GroupConfig(members=(0, 1, 2, 3, 4),
                               subgroups=(spec_a, spec_b))
    stream = port_api.Group(cfg, device="cpu").stream(backend="kernel")
    ready = np.zeros(stream.shape, np.int32)
    ready[0, :2] = 2
    ready[1, 0] = 1
    for _ in range(3):
        stream.step(ready)
    s2 = stream.reconfigure(port_api.View(vid=1, members=(0, 1, 2, 3),
                                          senders=(0, 1, 2, 3)))
    assert s2.carry is not None and s2.carry.total_resend() > 0
    assert (s2.n_max, s2.s_max) == (stream.n_max, stream.s_max)
    assert s2.n_members == (4, 2) and s2.device == stream.device
    n0 = len(calls)
    ready2 = np.zeros(s2.shape, np.int32)
    ready2[0, :2] = 1
    s2.step(ready2)
    report, _ = s2.finish()
    assert len(calls) - n0 == report.extras["streamed_rounds"]
    assert not report.stalled
    with pytest.raises(RuntimeError, match="closed"):
        stream.step(ready)
    with pytest.raises(RuntimeError, match="closed"):
        stream.finish()
    with pytest.raises(RuntimeError, match="closed"):
        stream.reconfigure(port_api.View(vid=2, members=(0, 1),
                                         senders=(0, 1)))


# ---------------------------------------------------------------------------
# BoundDomain.reconfigure and a carried Group's scheduled run
# ---------------------------------------------------------------------------


def _hetero_domain(api):
    """Topics with 1-3 publishers and 1-4 subscribers over 7 nodes (a
    padded, masked stack)."""
    d = api.Domain(n_nodes=7)
    for t in range(5):
        n_pub, n_sub = 1 + t % 3, 1 + (2 * t) % 4
        nodes = [(t + i) % 7 for i in range(n_pub + n_sub)]
        d.create_topic(f"topic-{t}", publishers=nodes[:n_pub],
                       subscribers=nodes[n_pub:], sample_size=1024,
                       window=3 + t)
    return d


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_bound_domain_reconfigure_on_a_heterogeneous_domain(port_backend):
    """Two nodes fail mid-stream: topics shrink, a topic whose only
    publisher died keeps a silent publisher, and the per-topic cut logs,
    the closing report and the re-bound stream equal the reference's."""
    out = {}
    for name, api, backend in (("port", port_api, port_backend),
                               ("ref", ref_api, "graph")):
        kw = {"device": "cpu"} if api is port_api else {}
        bound = _hetero_domain(api).bind(backend=backend, **kw)
        rng = np.random.default_rng(3)
        records = []

        def push(b, n):
            for _ in range(n):
                counts = {t.name: rng.integers(0, 3, len(t.publishers))
                          for t in b.domain.topics}
                b.push_round(counts)

        push(bound, 5)
        ms = api.MembershipService(range(7))
        ms.suspect(0, 2)
        ms.suspect(0, 5)
        view = ms.propose_and_install({})
        new_bound, old_report, old_logs = bound.reconfigure(view)
        records.append((old_report, old_logs))
        assert [t.name for t in new_bound.domain.topics] == \
            [t.name for t in bound.domain.topics]
        push(new_bound, 4)
        report, logs = new_bound.finish()
        records.append((report, logs))
        out[name] = (records, new_bound)
    (got, bp), (want, br) = out["port"], out["ref"]
    assert [(t.publishers, t.subscribers) for t in bp.domain.topics] == \
        [(t.publishers, t.subscribers) for t in br.domain.topics]
    _assert_carries_equal(bp.stream.carry, br.stream.carry, "carry")
    for (rg, lg), (rw, lw) in zip(got, want):
        for f in INT_FIELDS:
            assert getattr(rg, f) == getattr(rw, f), f
        _assert_logs_equal(lg, lw, "topics")
    vg = got[0][0].extras["view_change"]
    vw = want[0][0].extras["view_change"]
    assert vg["cut_seq"] == vw["cut_seq"]
    assert vg["resend_msgs"] == vw["resend_msgs"] > 0


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_run_on_a_carried_group(port_backend):
    """A scheduled run of the Group a cut hands back adds the carry's
    resends to every sender's counts, as the reference does."""
    out = {}
    for name, api, backend in (("port", port_api, port_backend),
                               ("ref", ref_api, "graph")):
        stream = _open(api, _two_subgroups(api), backend)
        rng = np.random.default_rng(13)
        for _ in range(4):
            ready = np.zeros(stream.shape, np.int32)
            ready[0, :3] = rng.integers(0, 4, 3)
            ready[1, :2] = rng.integers(0, 4, 2)
            stream.step(ready)
        new = stream.reconfigure(api.View(vid=1, members=(0, 1, 2, 4),
                                          senders=(0, 1, 2, 4)))
        g = new.group
        counts = [g.send_counts(gid) for gid in range(g.n_subgroups)]
        report = g.run(backend=backend)
        out[name] = (g, counts, report)
    (gp, cp, rp), (gr, cr, rr) = out["port"], out["ref"]
    assert gp.carry.total_resend() > 0
    for a, b in zip(cp, cr):
        np.testing.assert_array_equal(a, b)
    for f in INT_FIELDS:
        assert getattr(rp, f) == getattr(rr, f), f
    _assert_logs_equal(gp.delivery_logs, gr.delivery_logs, "carried run")
