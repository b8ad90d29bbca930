"""The SMC receive-sweep kernels of the port against the reference's
Pallas kernels (interpret mode on the CPU), at the shapes of
tests/test_kernels.py plus padded, masked, negative and full-mask cases.

Here, without a GPU, the port's wrappers run their plain twins (a CPU
tensor goes to the twin).  Where a GPU is present — decided inside each
test, never at import — the same tests also launch the CUDA kernel and
hold it against the twin and the reference.  Every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import smc_sweep as ref_ss
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import smc_sweep as ss

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")


def _t(x, device="cpu"):
    return torch.as_tensor(np.array(x, np.int32), device=device)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _lanes(rng, s, w):
    processed = rng.integers(0, 50, size=s)
    published = processed + rng.integers(0, w + 1, size=s)
    return published.astype(np.int32), processed.astype(np.int32)


def _watermark_everywhere(published, processed, w, valid=None):
    """The port's result on the CPU twin and, with a GPU, the kernel
    (which must agree exactly with the twin)."""
    args = dict(window=w)
    cpu = ss.smc_sweep_watermark(
        _t(published), _t(processed), **args,
        valid=None if valid is None else _t(valid))
    if torch.cuda.is_available():
        gpu = ss.smc_sweep_watermark(
            _t(published, "cuda"), _t(processed, "cuda"), **args,
            valid=None if valid is None else _t(valid, "cuda"))
        np.testing.assert_array_equal(_np(gpu), _np(cpu))
    return cpu


def _ring_everywhere(counters, processed):
    cpu = ss.smc_sweep(_t(counters), _t(processed))
    if torch.cuda.is_available():
        gpu = ss.smc_sweep(_t(counters, "cuda"), _t(processed, "cuda"))
        np.testing.assert_array_equal(_np(gpu), _np(cpu))
    return cpu


# (processed, run) rows: runs that end just before, at and just after the
# ring kernel's 32-slot chunks (whole rows at W = 32 and 64 too), W = 1,
# and runs that wrap across slot 0 of the ring, at widths the kernel reads
# in slot order (W % 4 == 0) and walks in j order
_RUNS = {
    "runs 31-33": (64, [(0, 31), (5, 32), (70, 33), (64, 64), (1, 0),
                        (31, 63)]),
    "runs at W=32": (32, [(0, 31), (3, 32), (40, 0), (31, 1)]),
    "W=1": (1, [(0, 0), (0, 1), (7, 1), (9, 0), (3, 1)]),
    "wrap W=16": (16, [(13, 10), (15, 16), (31, 2), (14, 5), (0, 16),
                       (7, 9), (8, 8), (12, 4)]),
    "wrap W=40": (40, [(35, 33), (39, 40), (79, 1), (20, 25)]),
    "wrap W=5": (5, [(4, 3), (3, 5), (9, 1), (1, 4), (0, 0), (2, 2),
                     (8, 5)]),
}


@pytest.mark.parametrize("s,w,runs", [
    pytest.param(8, 16, None, id="8-16"),
    pytest.param(16, 100, None, id="16-100"),
    pytest.param(5, 64, None, id="5-64")] + [
    pytest.param(len(rows), w, rows, id=label)
    for label, (w, rows) in _RUNS.items()])
def test_ring_sweep_matches_pallas(s, w, runs):
    rng = np.random.default_rng(7)
    if runs is None:
        published, processed = _lanes(rng, s, w)
    else:
        processed = np.array([p for p, _ in runs], np.int32)
        published = processed + np.array([r for _, r in runs], np.int32)
    counters = np.asarray(ref_ss.counters_from_counts(published, w))
    got = _ring_everywhere(counters, processed)
    want = ref_ops.smc_sweep(jnp.asarray(counters), jnp.asarray(processed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), published)
    np.testing.assert_array_equal(
        _np(ref.smc_sweep_ref(_t(counters), _t(processed))), published)


@pytest.mark.parametrize("s", [3, 5, 7, 9])
def test_ring_sweep_any_sender_count(s):
    """Sender counts that are no multiple of the Pallas block (8)."""
    rng = np.random.default_rng(11)
    published, processed = _lanes(rng, s, 16)
    counters = np.asarray(ref_ss.counters_from_counts(published, 16))
    got = _ring_everywhere(counters, processed)
    want = ref_ss.smc_sweep_pallas(jnp.asarray(counters),
                                   jnp.asarray(processed), interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("s,w", [(8, 16), (5, 32), (16, 100), (3, 1)])
def test_watermark_matches_pallas_and_ring(s, w):
    rng = np.random.default_rng(13)
    published, processed = _lanes(rng, s, w)
    got = _watermark_everywhere(published, processed, w)
    want = ref_ss.smc_sweep_watermark_pallas(
        jnp.asarray(published), jnp.asarray(processed), window=w,
        interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    ring = ss.smc_sweep(ss.counters_from_counts(_t(published), w),
                        _t(processed))
    np.testing.assert_array_equal(_np(got), _np(ring))


@pytest.mark.parametrize("s,w", [(8, 16), (5, 32), (13, 8)])
def test_watermark_validity_mask_matches_pallas(s, w):
    """Invalid lanes return ``processed`` unchanged whatever their
    (poisoned) published watermark holds."""
    rng = np.random.default_rng(17)
    published, processed = _lanes(rng, s, w)
    valid = rng.integers(0, 2, size=s).astype(bool)
    published = np.where(valid, published, processed + w).astype(np.int32)
    got = _watermark_everywhere(published, processed, w, valid)
    want = ref_ss.smc_sweep_watermark_pallas(
        jnp.asarray(published), jnp.asarray(processed), window=w,
        valid=jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got),
                                  np.where(valid, published, processed))


def test_watermark_full_mask_equals_unmasked():
    rng = np.random.default_rng(19)
    published, processed = _lanes(rng, 7, 16)
    masked = _watermark_everywhere(published, processed, 16,
                                   np.ones(7, np.int32))
    plain = _watermark_everywhere(published, processed, 16)
    np.testing.assert_array_equal(_np(masked), _np(plain))


@pytest.mark.parametrize("w", [1, 3, 8, 100])
def test_watermark_negative_and_wild_inputs_match_pallas(w):
    """Floor (not truncating) division: negative processed counts and
    published watermarks far from processed, masked and unmasked."""
    rng = np.random.default_rng(23 + w)
    n = 96
    processed = rng.integers(-3 * w, 3 * w + 1, size=n).astype(np.int32)
    published = rng.integers(-w, 5 * w + 1, size=n).astype(np.int32)
    valid = rng.random(n) < 0.7
    for v in (None, valid):
        got = _watermark_everywhere(published, processed, w, v)
        want = ref_ss.smc_sweep_watermark_pallas(
            jnp.asarray(published), jnp.asarray(processed), window=w,
            valid=None if v is None else jnp.asarray(v), interpret=True)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_twin_equals_ring_over_counters_from_counts(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.choice([1, 4, 16, 100]))
    n = 200
    published = rng.integers(-w, 6 * w, size=n).astype(np.int32)
    processed = rng.integers(-2 * w, 4 * w, size=n).astype(np.int32)
    counters = ss.counters_from_counts(_t(published), w)
    np.testing.assert_array_equal(
        _np(counters), np.asarray(ref_ss.counters_from_counts(published, w)))
    np.testing.assert_array_equal(
        _np(ss.smc_sweep_watermark_plain(_t(published), _t(processed), w)),
        _np(ss.smc_sweep_plain(counters, _t(processed))))


@pytest.mark.parametrize("w", [1, 3, 8, 100])
def test_closed_form_identity_for_nonnegative_inputs(w):
    """For non-negative inputs the sweep is processed + clamp(published -
    processed, 0, W) — the identity the kernel's source note records."""
    rng = np.random.default_rng(100 + w)
    n = 4096
    processed = rng.integers(0, 10 * w + 5, size=n).astype(np.int32)
    published = rng.integers(0, 10 * w + 5, size=n).astype(np.int32)
    got = _watermark_everywhere(published, processed, w)
    want = processed + np.clip(published - processed, 0, w)
    np.testing.assert_array_equal(_np(got), want)


def _extreme_lanes(rng, w, n):
    """Lanes within 2W of INT32_MAX, INT32_MIN and 0, published in (0, W)
    and <= 0, and arbitrary int32 values: where the int32 adds wrap and
    the counters go negative."""
    i32 = np.iinfo(np.int32)
    quarter = n // 4
    base = np.concatenate([np.full(quarter, i32.max, np.int64),
                           np.full(quarter, i32.min, np.int64),
                           np.zeros(n - 2 * quarter, np.int64)])
    processed = base + rng.integers(-2 * w, 2 * w + 1, size=n)
    published = base + rng.integers(-2 * w, 2 * w + 1, size=n)
    small = rng.random(n) < 0.25          # published in (0, W) or <= 0
    published = np.where(small, rng.integers(-w, w, size=n) + (w > 1),
                         published)
    wild = rng.random(n) < 0.2
    processed = np.where(wild, rng.integers(i32.min, i32.max, size=n),
                         processed)
    published = np.where(wild, rng.integers(i32.min, i32.max, size=n),
                         published)
    clip = lambda x: np.clip(x, i32.min, i32.max).astype(np.int32)
    return clip(published), clip(processed), rng.random(n) < 0.7


@pytest.mark.parametrize("w", [1, 3, 100, 1000])
def test_closed_form_matches_the_twin_and_pallas_at_the_extremes(w):
    """The kernel's closed form, processed + clamp(max(published, 0) -
    processed, 0, W) wrapped to int32, equals the plain twin's loop over
    the materialized ring and the reference's Pallas kernel exactly, with
    and without a mask, at INT32_MAX / INT32_MIN +- 2W, published <= 0
    and in (0, W), and arbitrary int32 lanes."""
    rng = np.random.default_rng(200 + w)
    published, processed, valid = _extreme_lanes(rng, w, 64)
    for v in (None, valid):
        mask = None if v is None else _t(v)
        got = ss.smc_sweep_watermark_closed_form(_t(published),
                                                 _t(processed), w, mask)
        assert got.dtype == torch.int32
        twin = ss.smc_sweep_watermark_plain(_t(published), _t(processed), w,
                                            mask)
        np.testing.assert_array_equal(_np(got), _np(twin))
        want = ref_ss.smc_sweep_watermark_pallas(
            jnp.asarray(published), jnp.asarray(processed), window=w,
            valid=None if v is None else jnp.asarray(v), interpret=True)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        np.testing.assert_array_equal(
            _np(_watermark_everywhere(published, processed, w, v)),
            _np(got))


@pytest.mark.parametrize("seed", range(3))
def test_closed_form_equals_the_twin_on_many_lanes(seed):
    """The same identity over 20k lanes a window, W in {1, 2, 7, 257}."""
    rng = np.random.default_rng(300 + seed)
    for w in (1, 2, 7, 257):
        published, processed, valid = _extreme_lanes(rng, w, 20000)
        pub, proc, mask = _t(published), _t(processed), _t(valid)
        for v in (None, mask):
            np.testing.assert_array_equal(
                _np(ss.smc_sweep_watermark_closed_form(pub, proc, w, v)),
                _np(ss.smc_sweep_watermark_plain(pub, proc, w, v)))


def test_ops_wrapper_takes_a_bool_mask():
    rng = np.random.default_rng(29)
    published, processed = _lanes(rng, 12, 8)
    valid = rng.random(12) < 0.5
    got = ops.smc_sweep_watermark(_t(published), _t(processed), window=8,
                                  valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(_np(got),
                                  np.where(valid, published, processed))


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_wrapper_rejects_bad_inputs():
    pub = _t(np.arange(6))
    proc = _t(np.zeros(6))
    with pytest.raises(TypeError, match="int32"):
        ss.smc_sweep_watermark(pub.long(), proc, window=4)
    with pytest.raises(ValueError, match="contiguous"):
        wide = _t(np.zeros((6, 2)))
        ss.smc_sweep_watermark(pub, wide[:, 0], window=4)
    with pytest.raises(ValueError, match="window"):
        ss.smc_sweep_watermark(pub, proc, window=0)
    with pytest.raises(ValueError, match="lane counts"):
        ss.smc_sweep_watermark(pub, proc[:5], window=4)
    with pytest.raises(ValueError, match="1-D"):
        ss.smc_sweep_watermark(pub.view(2, 3), proc.view(2, 3), window=4)
    with pytest.raises(TypeError, match="int32"):
        ss.smc_sweep_watermark(pub, proc, window=4,
                               valid=torch.ones(6, dtype=torch.bool))
    with pytest.raises(ValueError, match="do not match"):
        ss.smc_sweep(_t(np.zeros((5, 4))), proc)
    with pytest.raises(ValueError, match="window"):
        ss.smc_sweep(_t(np.zeros((6, 0))), proc)
    with pytest.raises(TypeError, match="int32"):
        ss.smc_sweep(_t(np.zeros((6, 4))).long(), proc)


def test_cpu_dispatch_runs_the_twin_and_counts_nothing():
    before = ss.launch_counts()
    rng = np.random.default_rng(31)
    published, processed = _lanes(rng, 10, 8)
    got = ss.smc_sweep_watermark(_t(published), _t(processed), window=8)
    ring = ss.smc_sweep(ss.counters_from_counts(_t(published), 8),
                        _t(processed))
    assert got.device.type == ring.device.type == "cpu"
    assert ss.launch_counts() == before


def test_build_is_keyed_on_source_and_flags():
    path = _build.library_path("smc_sweep")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("smc_sweep-") and path.suffix == ".so"
    assert path == _build.library_path("smc_sweep")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("w", [32, 33, 100, 256])
def test_ring_run_read_in_slot_order_equals_the_walk(w):
    """The ring kernel reads a row of W <= 256 slots whole, in slot order:
    slot s holds k with j = (s - r0) mod W (r0 = processed mod W) and
    needs floor(processed / W) + (s < r0), so the run is the first miss at
    or after slot r0, else the first before it, rotated by W.  That
    equals the walk over j on arbitrary rings, negative counts and counts
    near INT32_MIN (rows whose processed + W - 1 passes INT32_MAX walk in
    j order instead)."""
    rng = np.random.default_rng(w)
    i32 = np.iinfo(np.int32)
    n = 600
    base = rng.choice(np.array([i32.min, 0, 1000], np.int64), size=n)
    processed = base + rng.integers(-3 * w, 3 * w, size=n)
    processed = np.clip(processed, i32.min, i32.max - w).astype(np.int32)
    published = np.clip(processed + rng.integers(-1, w + 2, size=n),
                        i32.min, i32.max).astype(np.int32)
    counters = ss.counters_from_counts(_t(published), w).numpy()
    wild = rng.random(n) < 0.3            # arbitrary rings
    counters[wild] = (processed[wild, None].astype(np.int64) // w
                      + rng.integers(-3, 3, size=(wild.sum(), w)))
    p = processed.astype(np.int64)
    q0, r0 = p // w, p % w
    s = np.arange(w)[None, :]
    miss = counters < q0[:, None] + (s < r0[:, None])
    after = np.where(miss & (s >= r0[:, None]), s, w).min(axis=1)
    before = np.where(miss & (s < r0[:, None]), s, w).min(axis=1)
    run = np.where(after < w, after - r0,
                   np.where(before < w, before + w - r0, w))
    want = ss.smc_sweep_plain(_t(counters), _t(processed))
    np.testing.assert_array_equal(p + run, _np(want).astype(np.int64))
