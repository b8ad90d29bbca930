"""The port's discrete-event simulator against the reference's, on the CPU.

``repro_torch.core.simulator`` (the legacy single-phase ``Simulator``),
``repro_torch.core.desgraph`` (phase 1: every ``DesGraph`` event array
and the final per-subgroup protocol state) and
``repro_torch.core.desreplay.replay`` (phase 2) are held to the
reference's modules on the same scenarios, and the port's ``des`` and
``des-loop`` ``Group`` backends to the reference's ``RunReport``s and
``DeliveryLog``s.  The tolerance is exact, floats included: the DES is
host numpy code in both packages, the same IEEE-754 operations in the
same order, so every modelled time, latency percentile and per-node
throughput must be bit-identical (``tests/test_des_scale.py::_eq``).
The scenarios are ``tests/test_simulator.py``'s at small sizes,
``tests/test_des_scale.py``'s seeded heterogeneous stacks, flag corners,
N = 64 and its event-graph properties, and the N = 256 conformance of
the port's ``des`` with its CPU ``graph`` backend.
"""

import dataclasses
import types
import warnings

import jax
import numpy as np
import pytest

from repro import api as ref_api
from repro.configs import spindle_smc as ref_spindle_smc
from repro.core import dds as ref_dds
from repro.core import desgraph as ref_desgraph
from repro.core import desreplay as ref_desreplay
from repro.core import group as ref_group
from repro.core import simulator as ref_sim
from repro_torch import api
from repro_torch.configs import spindle_smc
from repro_torch.core import dds, desgraph, desreplay
from repro_torch.core import group as group_mod
from repro_torch.core import simulator as sim

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

PORT = types.SimpleNamespace(sim=sim, dds=dds, api=api,
                             PAPER=spindle_smc.PAPER)
REF = types.SimpleNamespace(sim=ref_sim, dds=ref_dds, api=ref_api,
                            PAPER=ref_spindle_smc.PAPER)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _eq(a, b, path=""):
    """Bit-exact structural equality (NaN == NaN, numpy vs scalar)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k in ("wall_s", "backend"):
                continue
            _eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) \
            and np.isnan(a) and np.isnan(b):
        pass
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _group_state(g):
    """The protocol state of one simulator ``_Group`` as plain arrays."""
    return {
        "pub_seen": g.pub_seen, "recv_counts": g.recv_counts,
        "recv_seen": g.recv_seen, "deliv_seen": g.deliv_seen,
        "published": g.published, "generated": g.generated,
        "next_ready": g.next_ready, "delivered_app": g.delivered_app,
        "last_delivery_time": g.last_delivery_time,
        "gen_len": g.gen_len, "active": g.active, "msgs": g.msgs,
        "total_app": g.total_app,
        "queued": [list(q) for q in g.queued],
        "gen_log": [g.gen_log[s][: int(g.gen_len[s])]
                    for s in range(g.n_s)],
    }


GRAPH_ARRAYS = ("sweep_node", "sweep_time", "sweep_dur", "sweep_work",
                "deliv_gid", "deliv_member", "deliv_lo", "deliv_hi",
                "deliv_napp", "deliv_time", "pub_gid", "pub_rank",
                "pub_count", "pub_is_null", "pub_time", "send_batches",
                "recv_batches", "deliv_batches", "rdma_writes",
                "nulls_sent", "sweeps", "post_time", "pred_time",
                "sender_blocked", "lock_busy", "first_gen", "stalled")


def _assert_graphs_equal(got, want, ctx):
    for f in GRAPH_ARRAYS:
        _eq(getattr(got, f), getattr(want, f), f"{ctx}:{f}")
    assert len(got.groups) == len(want.groups), ctx
    for i, (a, b) in enumerate(zip(got.groups, want.groups)):
        _eq(_group_state(a), _group_state(b), f"{ctx}:group{i}")


def _group(P, cfg):
    return P.api.Group(cfg, device="cpu") if P is PORT else P.api.Group(cfg)


def _run(P, cfg, backend):
    g = _group(P, cfg)
    report = g.run(backend=backend)
    return report, g.delivery_logs


def _logs(logs):
    return {gid: vars(log) for gid, log in logs.items()}


def _digest(logs):
    """Order-sensitive per-member delivery digest: the delivered sequence
    of (rank, idx, is_app) (``tests/test_des_scale.py::_digest``)."""
    out = {}
    for gid, log in sorted(logs.items()):
        for node in sorted(log.delivered_seq):
            out[(gid, node)] = log.sequence(node)
    return out


def _assert_group_runs_equal(build, ctx, backends=("des", "des-loop")):
    """Port ``des`` and ``des-loop`` against the reference's ``des``,
    and each other: reports and logs bit for bit."""
    want, want_logs = _run(REF, build(REF), "des")
    for be in backends:
        got, got_logs = _run(PORT, build(PORT), be)
        assert got.backend == be
        _eq(dataclasses.asdict(got), dataclasses.asdict(want),
            f"{ctx}:{be}:report")
        _eq(_logs(got_logs), _logs(want_logs), f"{ctx}:{be}:logs")


# ---------------------------------------------------------------------------
# the simulator, phase 1 and phase 2 against the reference's
# ---------------------------------------------------------------------------

def _pats(P, *entries):
    return tuple(((g, n), P.sim.SenderPattern(**kw)) for g, n, kw in entries)


SCENARIOS = {
    # tests/test_simulator.py's scenarios, cut to small sizes
    "spindle": lambda P: P.sim.single_subgroup(6, n_messages=60),
    "baseline": lambda P: P.sim.single_subgroup(
        5, n_messages=12, flags=P.sim.SpindleFlags.baseline()),
    "exactly_once": lambda P: P.sim.single_subgroup(5, n_messages=30),
    "inactive_no_nulls": lambda P: P.sim.single_subgroup(
        5, n_messages=20, flags=P.sim.SpindleFlags(null_send=False),
        patterns=_pats(P, (0, 2, dict(active=False))),
        target_delivered=4 * 20, max_time_us=2e4),
    "inactive_with_nulls": lambda P: P.sim.single_subgroup(
        5, n_messages=20, patterns=_pats(P, (0, 2, dict(active=False))),
        target_delivered=4 * 20),
    "window5": lambda P: P.sim.single_subgroup(6, window=5, n_messages=40),
    "multi_subgroup_baseline": lambda P: P.sim.SimConfig(
        n_nodes=5, flags=P.sim.SpindleFlags.baseline(),
        subgroups=tuple(P.sim.SubgroupSpec(
            members=tuple(range(5)), senders=tuple(range(5)),
            n_messages=10 if g == 0 else 0) for g in range(3))),
    "upcall_extra": lambda P: P.sim.single_subgroup(
        5, n_messages=25, upcall_extra_us=100.0,
        flags=P.sim.SpindleFlags(batched_upcall=False)),
    "send_delays": lambda P: P.sim.single_subgroup(
        5, n_messages=30, patterns=_pats(
            P, (0, 1, dict(inter_send_delay_us=3.0)),
            (0, 3, dict(inter_send_delay_us=0.5, n_messages=12)))),
    "target_delivered": lambda P: P.sim.single_subgroup(
        6, n_messages=40, target_delivered=70),
    "unordered_disk": lambda P: P.sim.single_subgroup(
        5, n_messages=25, flags=P.sim.SpindleFlags(
            wait_stability=False, disk_append=True, memcpy_send=True,
            memcpy_delivery=True)),
    "llc_spill": lambda P: P.sim.single_subgroup(
        4, n_messages=30, llc_bytes=1 << 20),
    "dds_logged": lambda P: _quiet_sim_config(
        P.dds.single_topic_domain(6, 5, qos=P.dds.QoS.LOGGED),
        samples_per_publisher=30),
    "paper_testbed": lambda P: P.PAPER.config(8, n_messages=20),
}


def _quiet_sim_config(domain, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return domain.sim_config(**kw)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulator_phase1_and_replay_match_the_reference(name):
    """``Simulator.run``, ``desgraph.simulate`` (every event array and
    the final state) and ``desreplay.replay`` against the reference's;
    the two-phase result equals the legacy loop's."""
    cfg, ref_cfg = SCENARIOS[name](PORT), SCENARIOS[name](REF)
    _eq(dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg), "cfg")
    loop = sim.Simulator(cfg)
    got = loop.run()
    ref_loop = ref_sim.Simulator(ref_cfg)
    want = ref_loop.run()
    _eq(got, want, f"{name}:loop")
    for a, b in zip(loop.groups, ref_loop.groups):
        _eq(_group_state(a), _group_state(b), f"{name}:loop state")
    graph, ref_graph = desgraph.simulate(cfg), ref_desgraph.simulate(ref_cfg)
    _assert_graphs_equal(graph, ref_graph, name)
    replayed = desreplay.replay(graph)
    _eq(replayed, ref_desreplay.replay(ref_graph), f"{name}:replay")
    _eq(replayed, want, f"{name}:replay vs reference loop")
    _eq(replayed, got, f"{name}:replay vs loop")
    assert got.summary() == want.summary()


def test_simulator_headline_claims_hold_on_the_port():
    """The ordering claims of ``tests/test_simulator.py`` at its sizes
    that run in a few seconds: Spindle is an order above the baseline,
    an inactive sender stalls only without nulls, every message is
    delivered exactly once."""
    spin = sim.run(sim.single_subgroup(8, n_messages=200))
    base = sim.run(sim.single_subgroup(
        8, n_messages=50, flags=sim.SpindleFlags.baseline()))
    assert spin.throughput_GBps > 8 * base.throughput_GBps
    assert spin.mean_latency_us < base.mean_latency_us / 5
    r = sim.run(sim.single_subgroup(5, n_messages=100))
    assert not r.stalled and r.delivered_app_msgs == 5 * 5 * 100
    stalled = sim.run(SCENARIOS["inactive_no_nulls"](PORT))
    covered = sim.run(SCENARIOS["inactive_with_nulls"](PORT))
    assert stalled.stalled and not covered.stalled
    assert covered.nulls_sent > 0


# ---------------------------------------------------------------------------
# the Group backends: seeded stacks, null-send, flag corners, N = 64
# ---------------------------------------------------------------------------

def _rand_stack(P, rng, n_nodes, n_groups):
    """``tests/test_des_scale.py::_rand_stack`` over package ``P``."""
    nodes = np.arange(n_nodes)
    specs = []
    for _ in range(n_groups):
        n_m = int(rng.integers(2, min(n_nodes, 7) + 1))
        members = tuple(int(m) for m in
                        rng.choice(nodes, size=n_m, replace=False))
        n_s = int(rng.integers(1, n_m + 1))
        senders = tuple(int(s) for s in
                        rng.choice(members, size=n_s, replace=False))
        specs.append(P.api.SubgroupSpec(
            members=members, senders=senders,
            window=int(rng.integers(2, 7)),
            msg_size=int(rng.choice([64, 512, 4096])),
            n_messages=int(rng.integers(1, 9))))
    return P.api.GroupConfig(members=tuple(range(n_nodes)),
                             subgroups=tuple(specs))


def _stack_builder(seed, case, **replace):
    def build(P):
        rng = np.random.default_rng(seed)
        for _ in range(case):
            _rand_stack(P, rng, int(rng.integers(4, 9)),
                        int(rng.integers(1, 4)))
        cfg = _rand_stack(P, rng, int(rng.integers(4, 9)),
                          int(rng.integers(1, 4)))
        if replace:
            cfg = dataclasses.replace(cfg, flags=dataclasses.replace(
                cfg.flags, **replace))
        return cfg
    return build


@pytest.mark.parametrize("case", range(8))
def test_heterogeneous_stacks_match_the_reference(case):
    _assert_group_runs_equal(_stack_builder(1234, case), f"case{case}")


@pytest.mark.parametrize("null_send", [True, False])
@pytest.mark.parametrize("case", range(3))
def test_null_send_on_and_off_match_the_reference(case, null_send):
    _assert_group_runs_equal(
        _stack_builder(77, case, null_send=null_send),
        f"case{case}:null={null_send}")


CORNERS = (
    dict(batch_receive=False, batch_delivery=False, batch_send=False,
         null_send=False, early_lock_release=False, batched_upcall=False,
         wait_stability=False),
    dict(memcpy_delivery=True, memcpy_send=True, disk_append=True),
    dict(early_lock_release=False),
    dict(batch_send=False, wait_stability=False),
)


@pytest.mark.parametrize("corner", range(len(CORNERS)))
def test_flag_corners_match_the_reference(corner):
    def build(P):
        rng = np.random.default_rng(9)
        cfg = _rand_stack(P, rng, 7, 3)
        return dataclasses.replace(cfg, flags=P.api.SpindleFlags(
            **CORNERS[corner]))
    _assert_group_runs_equal(build, f"corner{corner}")


def test_inactive_sender_delays_and_upcall_extra_through_the_group():
    """Patterns (an inactive sender, send delays, a per-sender budget),
    ``target_delivered`` and ``upcall_extra_us`` reach the DES through
    ``GroupConfig``."""
    def build(P):
        spec = P.api.SubgroupSpec(members=(0, 1, 2, 3, 4),
                                  senders=(0, 1, 2, 3), window=6,
                                  msg_size=2048, n_messages=18)
        pats = _pats(P, (0, 1, dict(active=False)),
                     (0, 2, dict(inter_send_delay_us=4.0)),
                     (0, 3, dict(n_messages=7)))
        return P.api.GroupConfig(members=tuple(range(5)),
                                 subgroups=(spec,), patterns=pats,
                                 target_delivered=30,
                                 upcall_extra_us=2.5)
    _assert_group_runs_equal(build, "patterns")
    report, _ = _run(PORT, build(PORT), "des")
    plain, _ = _run(PORT, dataclasses.replace(
        build(PORT), upcall_extra_us=0.0), "des")
    assert report.mean_latency_us != plain.mean_latency_us


def _big_cfg(P, n_nodes, n_senders=8, n_messages=4, window=16,
             rounds=None):
    spec = P.api.SubgroupSpec(members=tuple(range(n_nodes)),
                              senders=tuple(range(n_senders)),
                              window=window, msg_size=1024,
                              n_messages=n_messages)
    return P.api.GroupConfig(members=tuple(range(n_nodes)),
                             subgroups=(spec,), rounds=rounds)


def test_n64_matches_the_reference():
    _assert_group_runs_equal(lambda P: _big_cfg(P, 64, n_messages=6),
                             "n64")


def test_graph_vs_des_conformance_n256():
    """The port's ``des`` against its CPU ``graph`` at N = 256: neither
    stalls, and every member's delivered sequence agrees."""
    cfg = _big_cfg(PORT, 256, n_messages=4, rounds=24)
    r_des, l_des = _run(PORT, cfg, "des")
    r_g, l_g = _run(PORT, cfg, "graph")
    assert not r_des.stalled and not r_g.stalled
    assert r_des.delivered_app_msgs == r_g.delivered_app_msgs
    assert _digest(l_des) == _digest(l_g)


def test_run_and_run_batch_match_the_reference():
    """``Group.run`` with upcalls and explicit sends, and ``run_batch``
    (sequential per point) against the reference's."""
    out = {}
    for name, P in (("port", PORT), ("ref", REF)):
        cfg = P.api.single_group(4, n_senders=3, window=5, n_messages=9)
        g = _group(P, cfg)
        seen = []
        g.subgroup(0).on_delivery(
            lambda member, d, seen=seen: seen.append(
                (member, d.seq, d.sender_rank, d.sender_index)))
        g.subgroup(0).send(sender=0, n=7)
        g.subgroup(0).send(sender=2, n=4)
        report = g.run(backend="des")
        logs = g.delivery_logs
        batch = g.run_batch(backend="des", windows=[2, 5, 9])
        # null_send off needs equal budgets, or the order never advances
        batch += _group(P, cfg).run_batch(backend="des",
                                          null_send=[False, True])
        out[name] = (report, logs, seen, batch)
    (rep, logs, seen, batch), (rrep, rlogs, rseen, rbatch) = \
        out["port"], out["ref"]
    _eq(dataclasses.asdict(rep), dataclasses.asdict(rrep), "run")
    _eq(_logs(logs), _logs(rlogs), "logs")
    assert seen == rseen and len(seen) == rep.delivered_app_msgs
    assert len(batch) == len(rbatch) == 5
    for i, (a, b) in enumerate(zip(batch, rbatch)):
        la, lb = a.extras.pop("delivery_logs"), b.extras.pop(
            "delivery_logs")
        _eq(dataclasses.asdict(a), dataclasses.asdict(b), f"point{i}")
        _eq(_logs(la), _logs(lb), f"point{i}:logs")
    g = _group(PORT, PORT.api.single_group(4, n_senders=3, window=5,
                                           n_messages=9))
    g.subgroup(0).send(sender=0, n=7)
    g.subgroup(0).send(sender=2, n=4)
    for i, w in enumerate((2, 5, 9)):
        single = g.run(backend="des", subgroups=(dataclasses.replace(
            g.cfg.subgroups[0], window=w),))
        _eq(dataclasses.asdict(single), dataclasses.asdict(batch[i]),
            f"sequential point{i}")
    assert not batch[3].stalled and batch[3].nulls_sent == 0


# ---------------------------------------------------------------------------
# event-graph properties (ports of tests/test_des_scale.py)
# ---------------------------------------------------------------------------

def test_event_graph_invariant_under_subgroup_permutation():
    """Permuting the declaration order of disjoint subgroups reorders no
    same-timestamp event: the sweep timeline and the per-subgroup event
    slices are unchanged (the ``(time, node, seq)`` heap key)."""
    sa = api.SubgroupSpec(members=(0, 1, 2), senders=(0, 1),
                          window=3, msg_size=512, n_messages=6)
    sb = api.SubgroupSpec(members=(3, 4, 5, 6), senders=(3, 5, 6),
                          window=4, msg_size=256, n_messages=5)
    members = tuple(range(7))
    graphs = {}
    for tag, subgroups in (("ab", (sa, sb)), ("ba", (sb, sa))):
        cfg = api.GroupConfig(members=members, subgroups=subgroups)
        counts = {g: np.full(len(s.senders), s.n_messages, np.int64)
                  for g, s in enumerate(cfg.subgroups)}
        graphs[tag] = desgraph.simulate(
            group_mod.DESLoopBackend._lower(cfg, counts))
        ref_cfg = ref_api.GroupConfig(
            members=members, subgroups=tuple(
                ref_api.SubgroupSpec(**dataclasses.asdict(s))
                for s in subgroups))
        _assert_graphs_equal(graphs[tag], ref_desgraph.simulate(
            ref_group.DESLoopBackend._lower(ref_cfg, counts)), tag)
    ga, gb = graphs["ab"], graphs["ba"]
    for f in ("sweep_node", "sweep_time", "sweep_dur"):
        _eq(getattr(ga, f), getattr(gb, f), f)
    for key, fields in (("deliv", ("member", "lo", "hi", "napp", "time")),
                        ("pub", ("rank", "count", "is_null", "time"))):
        for g_a, g_b in ((0, 1), (1, 0)):
            ma = getattr(ga, f"{key}_gid") == g_a
            mb = getattr(gb, f"{key}_gid") == g_b
            for f in fields:
                _eq(getattr(ga, f"{key}_{f}")[ma],
                    getattr(gb, f"{key}_{f}")[mb], f"{key}_{f}:g{g_a}")


def test_post_chain_matches_sequential_reference():
    """The two cumsum regimes of ``Phase1._post_record`` reproduce the
    sequential ``L_i = fl(max(L_{i-1}, t_i) + ser)`` recurrence bit for
    bit, for serialization above and below the post cost."""
    rng = np.random.default_rng(3)
    cfg = api.single_group(5, n_senders=2, n_messages=1)
    counts = {0: np.ones(2, np.int64)}
    for size in (64, 700, 4096, 65536):
        for link0_off in (-3.0, 0.0, 2.5, 1000.0):
            p1 = desgraph.Phase1(group_mod.DESLoopBackend._lower(cfg,
                                                                 counts))
            net = p1.cfg.net
            t0 = float(rng.uniform(5.0, 50.0))
            p1.link_free[0] = t0 + link0_off
            link0 = p1.link_free[0]
            g = p1.groups[0]
            st = p1._stream_for(g, 0, 0)
            ser = net.serialization(size)
            ref, link, t = [], link0, t0
            for _ in range(len(st.dsts)):
                t += net.post_us
                link = max(link, t) + ser
                ref.append(link)
            p1._post_record(0, t0, st, size, 7, g.recv_seen, 0)
            wl = net.wire_latency(min(size, 4096))
            np.testing.assert_array_equal(
                np.asarray(st.arrs[-1]),
                np.maximum(np.asarray(ref) + wl, 0.0))
            assert p1.link_free[0] == ref[-1]


# ---------------------------------------------------------------------------
# configuration surfaces
# ---------------------------------------------------------------------------

def test_paper_config_matches_the_reference():
    for kw in (dict(), dict(n_nodes=4, n_messages=10),
               dict(flags="baseline", upcall_extra_us=5.0)):
        def build(P, kw=kw):
            kw = dict(kw)
            if kw.get("flags") == "baseline":
                kw["flags"] = P.sim.SpindleFlags.baseline()
            return P.PAPER.config(**kw)
        _eq(dataclasses.asdict(build(PORT)), dataclasses.asdict(build(REF)),
            str(kw))
    _eq(dataclasses.asdict(spindle_smc.PAPER),
        dataclasses.asdict(ref_spindle_smc.PAPER), "PAPER")


def test_group_config_round_trips_a_sim_config():
    cfg = sim.single_subgroup(4, n_messages=7, upcall_extra_us=1.5,
                              llc_bytes=1 << 22, max_sweeps=12345,
                              idle_tick_us=3.0, max_time_us=5e5,
                              target_delivered=9)
    g = api.Group.from_sim_config(cfg, device="cpu")
    assert g.cfg.to_sim_config() == cfg
    ref_cfg = ref_sim.single_subgroup(
        4, n_messages=7, upcall_extra_us=1.5, llc_bytes=1 << 22,
        max_sweeps=12345, idle_tick_us=3.0, max_time_us=5e5,
        target_delivered=9)
    _eq(dataclasses.asdict(g.cfg), dataclasses.asdict(
        ref_api.GroupConfig.from_sim_config(ref_cfg)), "GroupConfig")
    _eq(dataclasses.asdict(g.run(backend="des")),
        dataclasses.asdict(ref_api.Group.from_sim_config(ref_cfg).run(
            backend="des")), "report")


def test_domain_group_and_sim_config_match_the_reference(monkeypatch):
    """``Domain.group().run(backend="des")`` and the deprecated
    ``Domain.sim_config`` shim (warning once) against the reference's."""
    monkeypatch.setattr(dds, "_SIM_CONFIG_WARNED", False)
    monkeypatch.setattr(ref_dds, "_SIM_CONFIG_WARNED", False)
    out = {}
    for name, P in (("port", PORT), ("ref", REF)):
        d = P.dds.many_topic_domain(6, 4, subscribers_per_topic=3,
                                    window=5)
        g = d.group(samples_per_publisher=12, spindle=False,
                    **({"device": "cpu"} if P is PORT else {}))
        report = g.run(backend="des")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cfg1 = d.sim_config(samples_per_publisher=12, spindle=False,
                                upcall_extra_us=1.0)
            cfg2 = d.sim_config(samples_per_publisher=12, spindle=False)
        assert [w.category for w in caught] == [DeprecationWarning]
        out[name] = (report, g.delivery_logs, cfg1, cfg2)
    for i in range(4):
        a, b = out["port"][i], out["ref"][i]
        if i == 1:
            _eq(_logs(a), _logs(b), "logs")
        else:
            _eq(dataclasses.asdict(a), dataclasses.asdict(b), f"item{i}")
    assert out["port"][2].upcall_extra_us == 1.0


def test_des_backends_touch_no_device_and_take_any():
    """A DES backend built with no device asks for none (it runs on the
    host); through ``get_backend`` it records the Group's."""
    for be in (group_mod.DESBackend(), group_mod.DESLoopBackend()):
        assert be.device is None
        report, logs = be.run(api.single_group(3, n_messages=4),
                              {0: np.full(3, 4, np.int64)})
        assert report.delivered_app_msgs == 3 * 3 * 4 and logs[0]
    assert group_mod.get_backend("des", "cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="'kernel' is the counterpart"):
        group_mod.get_backend("pallas", "cpu")
