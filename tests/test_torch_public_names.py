"""The last of the reference's public names in the port, each against the
reference on the same inputs: the SST schema of the paper's Table 1
(``core/sst.py``: ``SSTColumn``, ``SSTSchema``, ``multicast_schema``,
``merge_tables``, ``update_own_row`` with its monotonicity check on host
tables), ``core/delivery.py::deliver``, ``models/layers.py::layer_norm``
and ``core/placement.py::BATCH_AXIS``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delivery as ref_delivery
from repro.core import placement as ref_placement
from repro.core import sst as ref_sst
from repro.models import layers as ref_layers
from repro_torch.core import delivery, placement, sst
from repro_torch.models import layers


@pytest.mark.parametrize("g,window", [(1, 4), (3, 16)])
def test_multicast_schema_is_table_one(g, window):
    want = ref_sst.multicast_schema(g, window, 10240)
    got = sst.multicast_schema(g, window, 10240)
    assert [(c.name, tuple(c.shape), np.dtype(c.dtype), c.init)
            for c in got.columns] == \
        [(c.name, tuple(c.shape), np.dtype(c.dtype), c.init)
         for c in want.columns]
    assert got.row_bytes() == want.row_bytes()
    tw, tg = want.make_table(5), got.make_table(5)
    assert tg.keys() == tw.keys()
    for k in tw:
        assert tg[k].dtype == tw[k].dtype and np.array_equal(tg[k], tw[k])
        assert torch.equal(got.make_table(5, torch)[k],
                           torch.from_numpy(tw[k]))
    assert got.column("slot_counter").shape == (g, window)
    with pytest.raises(KeyError):
        got.column("nope")
    col = sst.SSTColumn("x")
    with pytest.raises(ValueError, match="duplicate"):
        sst.SSTSchema(columns=(col, col))


def _tables(seed: int):
    rng = np.random.default_rng(seed)
    schema = ref_sst.multicast_schema(2, 8, 1024)
    return [{c.name: rng.integers(-1, 50, size=(4,) + c.shape).astype(
        np.int32) for c in schema.columns} for _ in range(2)]


def test_merge_tables_is_the_elementwise_max_on_host_and_tensor_tables():
    local, incoming = _tables(60)
    want = ref_sst.merge_tables(local, incoming)
    host = sst.merge_tables(local, incoming)
    tens = sst.merge_tables({k: torch.from_numpy(v) for k, v in
                             local.items()}, incoming)
    want_j = ref_sst.merge_tables({k: jnp.asarray(v)
                                   for k, v in local.items()}, incoming)
    for k in want:
        assert isinstance(host[k], np.ndarray)
        assert np.array_equal(host[k], want[k])
        assert isinstance(tens[k], torch.Tensor)
        assert np.array_equal(tens[k].numpy(), np.asarray(want_j[k]))


def test_update_own_row_checks_monotonicity_on_host_tables():
    table, _ = _tables(61)
    row = table["received_num"][2] + np.array([3, 0], np.int32)
    want = ref_sst.update_own_row(table, 2, "received_num", row)
    got = sst.update_own_row(table, 2, "received_num", row)
    for k in want:
        assert np.array_equal(got[k], want[k])
    assert got["received_num"] is not table["received_num"]
    back = table["received_num"][2] - 1
    for fn in (ref_sst.update_own_row, sst.update_own_row):
        with pytest.raises(ValueError, match="non-monotonic"):
            fn(table, 2, "received_num", back)
    unchecked = sst.update_own_row(table, 2, "received_num", back,
                                   check=False)
    assert np.array_equal(unchecked["received_num"][2], back)
    # a tensor table takes the max: a stale row cannot roll it back
    tens = {k: torch.from_numpy(v) for k, v in table.items()}
    want_j = ref_sst.update_own_row({k: jnp.asarray(v)
                                     for k, v in table.items()},
                                    2, "received_num", jnp.asarray(back))
    got_t = sst.update_own_row(tens, 2, "received_num", back)
    assert np.array_equal(got_t["received_num"].numpy(),
                          np.asarray(want_j["received_num"]))
    assert torch.equal(tens["received_num"],
                       torch.from_numpy(table["received_num"]))


@pytest.mark.parametrize("batched", [True, False])
def test_deliver_runs_the_reference_upcalls(batched):
    calls = {"ref": [], "port": []}
    for key, mod in (("ref", ref_delivery), ("port", delivery)):
        batch = mod.DeliveryBatch(lo_seq=5, hi_seq=17, n_senders=3)
        mod.deliver(batch, lambda *a, key=key: calls[key].append(a),
                    batched=batched,
                    batch_upcall=lambda b, key=key: calls[key].append(
                        ("batch", b.lo_seq, b.hi_seq, b.n_senders)))
    assert calls["port"] == calls["ref"]
    assert len(calls["port"]) == (1 if batched else 13)
    got = []
    delivery.deliver(delivery.DeliveryBatch(0, 3, 2), lambda *a:
                     got.append(a))
    assert got == [(0, 0, 0), (1, 1, 0), (2, 0, 1), (3, 1, 1)]


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       ("bfloat16", 2e-2)])
def test_layer_norm_matches_the_reference(dtype, tol):
    rng = np.random.default_rng(62)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 96))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    want = ref_layers.layer_norm(*(jnp.asarray(a).astype(jdt)
                                   for a in (x, w, b)))
    got = layers.layer_norm(*(torch.from_numpy(a).to(tdt)
                              for a in (x, w, b)))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_the_batch_axis_is_the_references():
    assert placement.BATCH_AXIS == ref_placement.BATCH_AXIS == "data"
