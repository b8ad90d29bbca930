"""The port's ``Group`` API against the reference's, scenario by scenario.

Port ``"graph"`` is held against reference ``"graph"`` and port
``"kernel"`` against reference ``"pallas"`` (its Pallas kernel in
interpret mode), both on ``device="cpu"``.  Delivery logs, upcalls and
every integer report field must be bit-identical.  Float report fields
(modelled duration, latencies, throughput) are held at rtol=1e-6: the
cost fold runs in float32, where the two frameworks may contract a
multiply-add differently.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro_torch import api as port_api
from repro_torch.core import group as port_group

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

BACKENDS = [("graph", "graph"), ("kernel", "pallas")]
INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled", "send_batches",
              "recv_batches", "deliv_batches")
FLOAT_FIELDS = ("throughput_GBps", "mean_latency_us", "p99_latency_us",
                "duration_us")
RTOL = 1e-6


def _assert_logs_equal(port_logs, ref_logs):
    assert port_logs.keys() == ref_logs.keys()
    for gid, want in ref_logs.items():
        got = port_logs[gid]
        assert got.n_senders == want.n_senders
        assert got.delivered_seq == want.delivered_seq, gid
        assert len(got.is_app) == len(want.is_app)
        for x, y in zip(got.is_app, want.is_app):
            np.testing.assert_array_equal(x, y, err_msg=f"subgroup {gid}")


def _assert_reports_equal(got, want):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=0, err_msg=f)
    np.testing.assert_allclose(got.per_node_throughput,
                               want.per_node_throughput, rtol=RTOL, atol=0)


def _both(build, port_backend, ref_backend, prepare=None):
    """Build the scenario with each package's api, run it, compare, and
    return the two groups."""
    ref_g = ref_api.Group(build(ref_api))
    port_g = port_api.Group(build(port_api), device="cpu")
    seen = {}
    for key, g in (("ref", ref_g), ("port", port_g)):
        if prepare is not None:
            prepare(g)
        seen[key] = []
        for gid in range(g.n_subgroups):
            g.subgroup(gid).on_delivery(
                lambda member, d, out=seen[key]: out.append(
                    (member, d.subgroup, d.seq, d.sender_rank,
                     d.sender_index)))
    want = ref_g.run(backend=ref_backend)
    got = port_g.run(backend=port_backend)
    assert got.backend == port_backend
    _assert_reports_equal(got, want)
    _assert_logs_equal(port_g.delivery_logs, ref_g.delivery_logs)
    assert seen["port"] == seen["ref"]
    return port_g, ref_g


def _single(n):
    return lambda api: api.single_group(n, msg_size=1024, window=8,
                                        n_messages=12)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("n", [4, 6, 8])
def test_single_group(n, port_backend, ref_backend):
    port_g, _ = _both(_single(n), port_backend, ref_backend)
    assert port_g.subgroup(0).delivered(0)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_small_window_throttles(port_backend, ref_backend):
    _both(lambda api: api.single_group(5, msg_size=10240, window=2,
                                       n_messages=15),
          port_backend, ref_backend)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_inactive_sender_pattern_sends_nulls(port_backend, ref_backend):
    def build(api):
        return api.single_group(
            5, msg_size=512, window=4, n_messages=10,
            patterns=(((0, 1), api.SenderPattern(active=False)),
                      ((0, 3), api.SenderPattern(n_messages=4))))
    port_g, _ = _both(build, port_backend, ref_backend)
    assert port_g.last_report.nulls_sent > 0


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_explicit_sends(port_backend, ref_backend):
    def prepare(g):
        g.subgroup(0).send(sender=2, n=7)
        g.subgroup(0).ordered_send(n=3)
    _both(lambda api: api.single_group(4, n_senders=3, msg_size=256,
                                       window=4, n_messages=50),
          port_backend, ref_backend, prepare)


def _hetero(api, target=None):
    rng = np.random.default_rng(42)
    specs = []
    for _ in range(3):
        n = int(rng.integers(2, 6))
        s = int(rng.integers(1, n + 1))
        specs.append(api.SubgroupSpec(
            members=tuple(range(n)), senders=tuple(range(s)),
            msg_size=int(rng.choice([256, 1024])),
            window=int(rng.choice([4, 8, 16])),
            n_messages=int(rng.integers(3, 12))))
    n_nodes = max(len(sp.members) for sp in specs)
    return api.GroupConfig(members=tuple(range(n_nodes)),
                           subgroups=tuple(specs), target_delivered=target)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("target", [None, 10])
def test_heterogeneous_stack(target, port_backend, ref_backend):
    _both(lambda api: _hetero(api, target), port_backend, ref_backend)


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("grid", [{"windows": [2, 5, 9]},
                                  {"null_send": [True, False]},
                                  {"n_messages": [3, 8]}],
                         ids=["windows", "null_send", "n_messages"])
def test_run_batch_grid(grid, port_backend, ref_backend):
    def build(api):
        return dataclasses.replace(
            _hetero(api), patterns=(((0, 1), api.SenderPattern(
                active=False)),))
    ref_reports = ref_api.Group(build(ref_api)).run_batch(
        backend=ref_backend, **grid)
    port_reports = port_api.Group(build(port_api), device="cpu").run_batch(
        backend=port_backend, **grid)
    assert len(port_reports) == len(ref_reports)
    for got, want in zip(port_reports, ref_reports):
        _assert_reports_equal(got, want)
        _assert_logs_equal(got.extras["delivery_logs"],
                           want.extras["delivery_logs"])
        assert "batch_wall_s" in got.extras


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_epoch_carry_resend(port_backend, ref_backend):
    """A carried resend set rides the next epoch's schedule on top of the
    scenario's own counts (Group.send_counts)."""
    def prepare(g):
        mod = ref_api if isinstance(g, ref_api.Group) else port_api
        g.carry = mod.EpochCarry(
            from_epoch=0, cut_seq=(7,),
            resend=(np.array([3, 0, 2, 1]),),
            stable_apps=(np.array([2, 2, 1, 2]),),
            app_base=(np.array([2, 2, 1, 2]),))
    port_g, _ = _both(lambda api: api.single_group(
        4, msg_size=1024, window=4, n_messages=6),
        port_backend, ref_backend, prepare)
    np.testing.assert_array_equal(port_g.send_counts(0), [9, 6, 8, 7])
    assert port_g.carry.total_resend() == 6


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_many_topic_domain(port_backend, ref_backend):
    ref_g = ref_api.many_topic_domain(6, 8).group(samples_per_publisher=10)
    port_g = port_api.many_topic_domain(6, 8).group(
        samples_per_publisher=10, device="cpu")
    want = ref_g.run(backend=ref_backend)
    got = port_g.run(backend=port_backend)
    _assert_reports_equal(got, want)
    _assert_logs_equal(port_g.delivery_logs, ref_g.delivery_logs)


def test_heterogeneous_domain_uses_the_masked_path():
    """Topics of different sizes pad to a common stack with masks; the
    kernel backend's result equals the graph backend's and the
    reference's."""
    def build(api):
        d = api.Domain(n_nodes=6)
        for t in range(5):
            n_pub, n_sub = 1 + t % 3, 1 + t % 2
            nodes = [(t + i) % 6 for i in range(n_pub + n_sub)]
            d.create_topic(f"t{t}", publishers=nodes[:n_pub],
                           subscribers=nodes[n_pub:], sample_size=2048,
                           window=4 if t % 2 else 16)
        return d
    port_g = build(port_api).group(samples_per_publisher=6, device="cpu")
    members = tuple(len(s.members) for s in port_g.cfg.subgroups)
    senders = tuple(len(s.senders) for s in port_g.cfg.subgroups)
    assert port_group._stack_masks(members, senders)[0] is not None
    ref_g = build(ref_api).group(samples_per_publisher=6)
    want = ref_g.run(backend="pallas")
    got = port_g.run(backend="kernel")
    _assert_reports_equal(got, want)
    _assert_logs_equal(port_g.delivery_logs, ref_g.delivery_logs)
    graph = port_g.run(backend="graph")
    _assert_reports_equal(graph, got)


def test_entry_point_runs_on_the_gpu_or_raises():
    cfg = port_api.single_group(3, n_messages=2)
    if torch.cuda.is_available():
        assert port_api.Group(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_api.Group(cfg)
        with pytest.raises(RuntimeError):
            port_api.Group(cfg, device="cuda")
    assert port_api.Group(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["pallas", "nope"])
def test_reference_only_backends_are_refused(name):
    g = port_api.Group(port_api.single_group(3, n_messages=2), device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        g.run(backend=name)


@pytest.mark.parametrize("name", ["des", "des-loop"])
def test_des_backends_run(name):
    """The discrete-event backends run on a CPU Group and equal the
    reference's, every report field (floats included) and log exact."""
    port_g = port_api.Group(port_api.single_group(3, n_messages=2),
                            device="cpu")
    ref_g = ref_api.Group(ref_api.single_group(3, n_messages=2))
    got, want = port_g.run(backend=name), ref_g.run(backend=name)
    assert got.backend == name and got.delivered_app_msgs == 3 * 3 * 2
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _assert_logs_equal(port_g.delivery_logs, ref_g.delivery_logs)


def test_run_batch_needs_a_grid_and_equal_lengths():
    g = port_api.Group(port_api.single_group(3, n_messages=2), device="cpu")
    with pytest.raises(ValueError, match="at least one grid"):
        g.run_batch(backend="graph")
    with pytest.raises(ValueError, match="grid lengths differ"):
        g.run_batch(backend="graph", windows=[2, 3], null_send=[True])


def test_fold_cost_matches_host_mirror():
    rng = np.random.default_rng(4)
    cfg = port_api.single_group(5, msg_size=4096)
    cost = port_group._cost_params(cfg, cfg.subgroups[0]).astype(np.float32)
    app_pub = rng.integers(0, 3, size=(9, 5)).astype(np.int32)
    round_t, round_w = port_group._fold_cost(torch.as_tensor(app_pub),
                                             torch.as_tensor(cost))
    assert round_w.dtype == torch.int32 and round_t.dtype == torch.float32
    np.testing.assert_allclose(round_t.numpy(),
                               port_group.fold_cost_np(app_pub, cost),
                               rtol=RTOL)
    np.testing.assert_array_equal(
        round_w.numpy(), 20 + 4 * (app_pub > 0).sum(axis=1))
