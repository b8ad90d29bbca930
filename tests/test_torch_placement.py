"""The port's grid placement (``repro_torch.core.placement``): the
reference's shard-count policy, and ``Group.run_batch`` sharded over
explicitly named devices.

Four ``cpu`` devices stand in for four cards: each chunk of the grid
runs the stacked round loop on its device and the outputs are
concatenated on the first.  The sharded batch must be bit-identical to
the unsharded batch and to per-point ``Group.run`` — every report field
but the wall clocks, and every delivery log — on the ``graph`` and the
``kernel`` backends, including a heterogeneous masked two-subgroup
stack.  The reference's own sharded test
(``tests/test_stacked.py::test_run_batch_shards_over_virtual_devices_bit_identically``)
cannot make this check under its jax version; the unsharded reference
``run_batch`` is the oracle the sharded port grid is held to as well.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import placement as ref_placement
from repro_torch import api
from repro_torch.core import placement

pytestmark = pytest.mark.fast

CPU4 = ["cpu"] * 4
REPORT_FIELDS = ("throughput_GBps", "mean_latency_us", "p99_latency_us",
                 "duration_us", "delivered_app_msgs", "delivered_null_msgs",
                 "nulls_sent", "rdma_writes", "rounds", "per_node_throughput",
                 "stalled", "send_batches", "recv_batches", "deliv_batches")


@pytest.mark.parametrize("batch,n_devices,want", [
    (0, 4, 1), (8, 1, 1), (8, 4, 4), (6, 4, 3), (7, 4, 1), (4, 8, 4),
    (12, 8, 6), (1, 4, 1)])
def test_shard_count_is_the_largest_dividing_device_count(batch, n_devices,
                                                          want):
    assert placement.shard_count(batch, ["cpu"] * n_devices) == want


def test_batch_mesh_is_a_data_axis_over_a_device_prefix():
    mesh = placement.batch_mesh(["cpu"] * 4, 3)
    assert mesh.axis_names == (ref_placement.BATCH_AXIS,) == ("data",)
    assert mesh.shape == {"data": 3} and len(mesh.devices) == 3


def test_shard_over_batch_concatenates_the_chunks():
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    w = torch.tensor([1.0, -2.0, 0.5])
    calls = []

    def fn(a, b, scale):
        calls.append(a.shape[0])
        return a * scale + b.sum(), (a @ scale)[:, None]

    whole = fn(x, x, w)
    calls.clear()
    out = placement.shard_over_batch(fn, CPU4, n_batched_args=2)(x, x, w)
    assert calls == [2, 2, 2, 2]
    # b is batched too: each chunk sums only its own rows
    chunk_sums = x.reshape(4, 2, 3).sum(dim=(1, 2)).repeat_interleave(2)
    assert torch.equal(out[0], x * w + chunk_sums[:, None])
    assert torch.equal(out[1], whole[1])


def test_shard_over_batch_refuses_an_uneven_grid():
    fn = placement.shard_over_batch(lambda a: a, CPU4, n_batched_args=1)
    with pytest.raises(ValueError, match="equal"):
        fn(torch.zeros(6, 2))


def _cfg(mod, **kw):
    base = dict(n_senders=2, msg_size=512, window=8, n_messages=8)
    base.update(kw)
    n = base.pop("n_nodes", 4)
    return mod.single_group(n, **base)


def _hetero(mod):
    spec_a = mod.SubgroupSpec(members=(0, 1, 2), senders=(0, 1),
                              msg_size=512, window=8, n_messages=6)
    spec_b = mod.SubgroupSpec(members=(0, 1, 2, 3), senders=(2, 3),
                              msg_size=256, window=4, n_messages=4)
    return mod.GroupConfig(members=(0, 1, 2, 3),
                           subgroups=(spec_a, spec_b))


GRIDS = {"single": (_cfg, [4, 6, 8, 12, 16, 24, 32, 48]),
         "hetero": (_hetero, [4, 8, 16, 32])}


def _same(ra, rb, what):
    for f in REPORT_FIELDS:
        assert getattr(ra, f) == getattr(rb, f), (what, f)


def _same_logs(la, lb, what):
    assert la.keys() == lb.keys(), what
    for gid in la:
        assert la[gid].delivered_seq == lb[gid].delivered_seq, (what, gid)
        assert len(la[gid].is_app) == len(lb[gid].is_app), (what, gid)
        for x, y in zip(la[gid].is_app, lb[gid].is_app):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (what, gid)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("backend", ["graph", "kernel"])
def test_sharded_run_batch_is_bit_identical(grid, backend):
    make, windows = GRIDS[grid]
    group = api.Group(make(api), device="cpu")
    whole = group.run_batch(backend=backend, windows=windows)
    sharded = group.run_batch(backend=backend, windows=windows,
                              devices=CPU4)
    assert placement.shard_count(len(windows), CPU4) == 4
    for w, rs, rw in zip(windows, sharded, whole):
        _same(rs, rw, (grid, backend, w, "whole"))
        _same_logs(rs.extras["delivery_logs"], rw.extras["delivery_logs"],
                   (grid, backend, w, "whole"))
        base = make(api)
        subs = tuple(dataclasses.replace(s, window=w)
                     for s in base.subgroups)
        gi = api.Group(dataclasses.replace(base, subgroups=subs),
                       device="cpu")
        ri = gi.run(backend=backend)
        _same(rs, ri, (grid, backend, w, "point"))
        _same_logs(rs.extras["delivery_logs"], gi.delivery_logs,
                   (grid, backend, w, "point"))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sharded_run_batch_matches_the_reference_batch(grid):
    """The port's grid sharded over four devices against the reference's
    unsharded ``run_batch`` (its one-device vmap path)."""
    make, windows = GRIDS[grid]
    ref = ref_api.Group(make(ref_api)).run_batch(backend="graph",
                                                 windows=windows)
    got = api.Group(make(api), device="cpu").run_batch(
        backend="graph", windows=windows, devices=CPU4)
    for w, rr, rg in zip(windows, ref, got):
        assert (rr.delivered_app_msgs, rr.delivered_null_msgs,
                rr.nulls_sent, rr.rounds) == \
            (rg.delivered_app_msgs, rg.delivered_null_msgs, rg.nulls_sent,
             rg.rounds), (grid, w)
        _same_logs(rr.extras["delivery_logs"], rg.extras["delivery_logs"],
                   (grid, w))


def test_one_device_keeps_the_unsharded_path(monkeypatch):
    """A group on one device (the default) gets shard_count 1: no chunking,
    today's program."""
    calls = []
    real = placement.shard_over_batch
    monkeypatch.setattr(placement, "shard_over_batch",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    group = api.Group(_cfg(api), device="cpu")
    group.run_batch(backend="graph", windows=[4, 8])
    group.run_batch(backend="graph", windows=[4, 8], devices=["cpu"])
    group.run_batch(backend="graph", windows=[4, 8, 16], devices=["cpu"] * 2)
    assert calls == []
    group.run_batch(backend="graph", windows=[4, 8], devices=["cpu"] * 2)
    assert len(calls) == 1


def test_devices_are_refused_on_the_des_backends():
    group = api.Group(_cfg(api, n_messages=4), device="cpu")
    for backend in ("des", "des-loop"):
        with pytest.raises(ValueError, match="devices="):
            group.run_batch(backend=backend, windows=[4, 8], devices=CPU4)
