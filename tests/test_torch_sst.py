"""Port vs reference: SST round-robin arithmetic, the null-send rule, the
SMC ring and the delivery accounting, on the seeded cases of
tests/test_core_protocol.py and tests/test_stacked.py.

Inputs are made with seeded numpy and handed to both packages; every
integer result must be exactly equal, and int32 inputs must give int32
outputs in the port as they do in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delivery as ref_delivery
from repro.core import nullsend as ref_nullsend
from repro.core import smc as ref_smc
from repro.core import sst as ref_sst
from repro_torch.core import delivery, nullsend, smc, sst

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

_BASE_SEED = 20_000        # tests/test_core_protocol.py's seeds


def _rng(case: int) -> np.random.Generator:
    return np.random.default_rng(_BASE_SEED + case)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# round-robin arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(30))
def test_rr_prefix_matches_reference(case):
    rng = _rng(case)
    counts = rng.integers(0, 201, size=int(rng.integers(1, 17)))
    _eq(sst.rr_prefix(_t(counts)), ref_sst.rr_prefix(counts))
    got32 = sst.rr_prefix(_t(counts, torch.int32))
    want32 = ref_sst.rr_prefix(jnp.asarray(counts, jnp.int32))
    assert got32.dtype == torch.int32
    _eq(got32, want32)


def test_rr_prefix_batched_int32():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 9, size=(4, 3, 6)).astype(np.int32)
    got = sst.rr_prefix(_t(counts))
    assert got.dtype == torch.int32
    _eq(got, ref_sst.rr_prefix(jnp.asarray(counts)))


@pytest.mark.parametrize("case", range(30))
def test_sender_counts_matches_reference(case):
    rng = _rng(case)
    prefix = np.int32(rng.integers(0, 10_001))
    s = int(rng.integers(1, 17))
    got = sst.sender_counts(_t(prefix), s)
    assert got.dtype == torch.int32
    _eq(got, ref_sst.sender_counts(jnp.asarray(prefix), s))


def test_rr_prefix_masked_full_mask_and_padding():
    """tests/test_stacked.py's masked cases: a full mask equals the
    unmasked form, a padded garbage suffix never moves the prefix."""
    rng = np.random.default_rng(1)
    for _ in range(20):
        s = int(rng.integers(1, 9))
        counts = rng.integers(0, 6, size=(3, s)).astype(np.int32)
        mask = np.ones(s, bool)
        got = sst.rr_prefix_masked(_t(counts), _t(mask), s)
        assert got.dtype == torch.int32
        _eq(got, ref_sst.rr_prefix_masked(jnp.asarray(counts),
                                          jnp.asarray(mask), s))
    rng = np.random.default_rng(2)
    for _ in range(20):
        s = int(rng.integers(1, 6))
        pad = int(rng.integers(1, 5))
        padded = np.concatenate([rng.integers(0, 6, size=s),
                                 rng.integers(0, 9, size=pad)]).astype(
                                     np.int32)
        mask = np.arange(s + pad) < s
        got = sst.rr_prefix_masked(_t(padded), _t(mask), s)
        _eq(got, ref_sst.rr_prefix_masked(jnp.asarray(padded),
                                          jnp.asarray(mask), s))
        _eq(got, ref_sst.rr_prefix(padded[:s]))


def test_rr_prefix_masked_all_padded_row_wraps_like_int32():
    """An all-padded row drives the int-max sentinel through ``+ 1``; the
    port must wrap exactly as the reference's int32 arithmetic."""
    counts = np.array([[3, 1, 2], [4, 4, 4]], np.int32)
    mask = np.array([[False, False, False], [True, True, False]])
    s_eff = np.array([0, 2], np.int32)
    got = sst.rr_prefix_masked(_t(counts), _t(mask), _t(s_eff))
    want = ref_sst.rr_prefix_masked(jnp.asarray(counts), jnp.asarray(mask),
                                    jnp.asarray(s_eff))
    _eq(got, want)


def test_sender_counts_masked_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        s = int(rng.integers(1, 6))
        pad = int(rng.integers(0, 4))
        prefix = rng.integers(0, 30, size=4).astype(np.int32)
        got = sst.sender_counts_masked(_t(prefix), s, s + pad)
        want = ref_sst.sender_counts_masked(jnp.asarray(prefix), s, s + pad)
        assert got.dtype == torch.int32
        _eq(got, want)
    # a per-row (tensor) effective sender count, as the stacked sweep uses
    prefix = np.array([7, 11, 0, 5], np.int32)
    s_eff = np.array([1, 3, 2, 4], np.int32)
    got = sst.sender_counts_masked(_t(prefix), _t(s_eff), 4)
    for row in range(4):
        want = ref_sst.sender_counts_masked(
            jnp.asarray(prefix[row]), int(s_eff[row]), 4)
        _eq(got[row][: s_eff[row]], np.asarray(want)[: s_eff[row]])


def test_seq_rank_index_roundtrip():
    seqs = _t(np.arange(0, 97, dtype=np.int32))
    for s in (1, 3, 7):
        rank, idx = sst.rank_of(seqs, s), sst.index_of(seqs, s)
        _eq(sst.seq_of(rank, idx, s), np.arange(0, 97))
        _eq(rank, ref_sst.rank_of(np.arange(0, 97), s))
        _eq(idx, ref_sst.index_of(np.arange(0, 97), s))


@pytest.mark.parametrize("case", range(10))
def test_ragged_and_cascading_trim_match_reference(case):
    rng = _rng(case)
    n = int(rng.integers(2, 9))
    received = rng.integers(-1, 40, size=n)
    stages, alive = [], np.ones(n, bool)
    for _ in range(int(rng.integers(1, 4))):
        alive = alive & (rng.random(n) < 0.8)
        stages.append(alive.copy())
    assert sst.ragged_trim(_t(received), stages[0]) == \
        ref_sst.ragged_trim(received, stages[0])
    assert sst.cascading_trim(received, stages) == \
        ref_sst.cascading_trim(received, stages)


def test_cascading_trim_rejects_growing_survivor_set():
    with pytest.raises(ValueError):
        sst.cascading_trim([3, 4, 5], [[True, False, True],
                                       [True, True, True]])
    assert sst.ragged_trim([3, 4], [False, False]) == -1


# ---------------------------------------------------------------------------
# null-send rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(40))
def test_null_target_matches_reference(case):
    rng = _rng(case)
    i, k, j = (int(rng.integers(0, 8)), int(rng.integers(0, 101)),
               int(rng.integers(0, 8)))
    got = nullsend.null_target(i, _t(np.int32(k)), j)
    assert int(got) == int(ref_nullsend.null_target(i, k, j))
    assert not bool(nullsend.precedes(got, i, k, j))


@pytest.mark.parametrize("case", range(30))
def test_nulls_needed_matches_reference(case):
    rng = _rng(case)
    s = int(rng.integers(2, 9))
    rank = int(rng.integers(0, s))
    counts = rng.integers(0, 31, size=s)
    own_next = int(rng.integers(0, 31))
    got = nullsend.nulls_needed(rank, own_next, _t(counts))
    assert int(got) == int(ref_nullsend.nulls_needed(rank, own_next, counts))


def test_nulls_needed_quiescent_when_caught_up():
    counts = _t([10, 10, 10, 10])
    assert int(nullsend.nulls_needed(0, 10, counts)) == 0
    assert int(nullsend.nulls_needed(3, 9, counts)) == 0
    assert int(nullsend.nulls_needed(3, 8, counts)) == 1
    assert int(nullsend.nulls_needed(0, 9, counts)) == 1


# ---------------------------------------------------------------------------
# SMC ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(30))
def test_visible_from_counters_matches_reference(case):
    rng = _rng(case)
    window = int(rng.integers(1, 9))
    received = int(rng.integers(0, 41))
    published = max(received, min(int(rng.integers(0, 81)),
                                  received + window))
    counters = np.full(window, -1, dtype=np.int32)
    for k in range(published):
        counters[k % window] = k // window
    got = smc.visible_from_counters(_t(counters), _t(np.int32(received)),
                                    window)
    want = ref_smc.visible_from_counters(counters, np.int32(received),
                                         window)
    assert got.dtype == torch.int32
    assert int(got) == int(want) == published


def test_slot_arithmetic():
    for idx, w in ((0, 1), (17, 5), (1000, 64)):
        assert smc.counter_for(idx, w) * w + smc.slot_of(idx, w) == idx
        assert smc.free_slots(3, 1, w) == ref_smc.free_slots(3, 1, w)


def test_publish_builds_the_reference_ring():
    """Successive publishes into an SST table give the reference's ring
    (its numpy path), and the ring sweep reads it back."""
    n_nodes, n_sub, window = 3, 2, 5
    table_np = {"slot_counter": np.full((n_nodes, n_sub, window), -1,
                                        np.int32),
                "published_num": np.full((n_nodes, n_sub), -1, np.int32)}
    table_t = {k: _t(v) for k, v in table_np.items()}
    for node, sub, count in ((0, 0, 3), (0, 0, 9), (2, 1, 4), (0, 0, 9),
                             (1, 1, 12)):
        table_np = ref_smc.publish(table_np, node, sub, count, window)
        table_t = smc.publish(table_t, node, sub, count, window)
        for k in table_np:
            _eq(table_t[k], table_np[k])
    from repro_torch.kernels import ops
    ring = table_t["slot_counter"][:, 0].contiguous()
    seen = ops.smc_sweep(ring, _t(np.array([5, 0, 0], np.int32)))
    _eq(seen, [9, 0, 0])


# ---------------------------------------------------------------------------
# delivery accounting
# ---------------------------------------------------------------------------

def test_stable_seq_and_deliverable_range():
    col = np.array([[4, 7], [2, 9], [6, 3]], np.int32)
    _eq(delivery.stable_seq(_t(col)), ref_delivery.stable_seq(col))
    lo, hi = delivery.deliverable_range(_t(np.array([1, 1], np.int32)),
                                        _t(col))
    rlo, rhi = ref_delivery.deliverable_range(np.array([1, 1]), col)
    _eq(lo, rlo)
    _eq(hi, rhi)


@pytest.mark.parametrize("case", range(10))
def test_split_app_and_null_matches_reference(case):
    rng = _rng(case)
    s = int(rng.integers(1, 6))
    is_app = [rng.random(int(rng.integers(0, 20))) < 0.7 for _ in range(s)]
    lo = int(rng.integers(0, 30))
    hi = lo + int(rng.integers(-1, 40))
    for mod, ref in ((delivery, ref_delivery),):
        got = mod.split_app_and_null(mod.DeliveryBatch(lo, hi, s), is_app)
        want = ref.split_app_and_null(ref.DeliveryBatch(lo, hi, s), is_app)
        assert got == want
    app_pub = rng.integers(0, 3, size=12)
    nulls = rng.integers(0, 2, size=12)
    for n_pub in (0, 3, 11, 40):
        assert delivery.apps_in_publish_prefix(app_pub, nulls, n_pub) == \
            ref_delivery.apps_in_publish_prefix(app_pub, nulls, n_pub)
