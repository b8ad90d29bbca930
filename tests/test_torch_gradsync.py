"""The port's gradient reductions against the reference's.

The reference runs its collectives over a vmapped axis ``"w"`` (as
``tests/test_gradsync.py`` does, W = 8 workers on one CPU); the port
takes the same per-worker gradients stacked along a leading dim and
reduces over it.  Inputs come from seeded numpy generators, at the shapes
of ``tests/test_gradsync.py``.  Tolerances: the plain and validity means
1e-6; the compressed mean and its residuals 1e-6 plus one quantization
step (the shard's scale), since the reference's scale, compiled by XLA,
may sit one ulp from the port's IEEE division (``test_torch_quantize``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradsync as ref_gradsync
from repro.core import views as ref_views
from repro_torch import tree as tree_util
from repro_torch.core import gradsync, views
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(17,), (8, 9), (3, 4, 5), (128,), (2, 2)]
W = 8


def _per_worker(seed, shapes=SHAPES, workers=W):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(size=(workers,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# bucket plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(8))
def test_plan_matches_the_reference(case):
    rng = np.random.default_rng(34_000 + case)
    n_leaves = int(rng.integers(1, 9))
    target = int(rng.integers(64, 4097))
    tree = {f"w{i:02d}": np.zeros(tuple(int(d) for d in rng.integers(
        1, 9, size=int(rng.integers(1, 4)))), np.float32)
        for i in range(n_leaves)}
    ref_plan = ref_gradsync.make_plan(_jax(tree), target_bytes=target)
    plan = gradsync.make_plan(_torch(tree), target_bytes=target)
    assert plan.starts == ref_plan.starts
    assert plan.leaf_shapes == ref_plan.leaf_shapes
    assert plan.leaf_sizes == ref_plan.leaf_sizes
    for b in range(plan.n_buckets):
        assert plan.bucket_bytes(b) == ref_plan.bucket_bytes(b)


@pytest.mark.parametrize("stacked", [False, True])
def test_bucket_roundtrip(stacked):
    tree = _torch(_per_worker(1) if stacked else
                  {k: v[0] for k, v in _per_worker(1).items()})
    half = torch.arange(6 * W, dtype=torch.bfloat16).reshape(W, 6)
    tree["half"] = half if stacked else half[0]
    plan = gradsync.make_plan(tree_util.map(
        lambda t: t[0], tree) if stacked else tree, target_bytes=300)
    buckets = gradsync.flatten_buckets(tree, plan)
    assert all(b.shape[:-1] == ((W,) if stacked else ()) for b in buckets)
    back = gradsync.unflatten_buckets(buckets, plan)
    assert sorted(back) == sorted(tree)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])


# ---------------------------------------------------------------------------
# reductions: stacked workers against the reference's vmapped axis
# ---------------------------------------------------------------------------

def test_fused_and_per_tensor_match_the_reference():
    grads = _per_worker(10)
    plan_ref = ref_gradsync.make_plan({k: jnp.asarray(v[0])
                                       for k, v in grads.items()},
                                      target_bytes=1024)
    per_tensor = jax.vmap(
        lambda g: ref_gradsync.per_tensor_psum_mean(g, "w"),
        axis_name="w")(_jax(grads))
    fused = jax.vmap(lambda g: ref_gradsync.fused_psum_mean(g, plan_ref, "w"),
                     axis_name="w")(_jax(grads))
    plan = gradsync.make_plan({k: torch.from_numpy(v[0])
                               for k, v in grads.items()}, target_bytes=1024)
    got_pt = gradsync.per_tensor_psum_mean(_torch(grads))
    got_f = gradsync.fused_psum_mean(_torch(grads), plan)
    for k in grads:
        assert got_pt[k].shape == grads[k].shape[1:]
        _close(got_pt[k], per_tensor[k][0])
        _close(got_f[k], fused[k][0])
        _close(got_f[k], grads[k].mean(0))


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("valid", [[1, 1, 0, 1, 0, 1, 1, 1], [0] * W])
def test_psum_with_validity_matches_the_reference(valid, bucketed):
    grads = _per_worker(11)
    v = np.asarray(valid, np.float32)
    plan_ref = ref_gradsync.make_plan({k: jnp.asarray(x[0])
                                       for k, x in grads.items()},
                                      target_bytes=512) if bucketed else None
    out, count = jax.vmap(
        lambda g, m: ref_gradsync.psum_with_validity(g, m, "w", plan_ref),
        axis_name="w")(_jax(grads), jnp.asarray(v))
    plan = gradsync.make_plan({k: torch.from_numpy(x[0])
                               for k, x in grads.items()},
                              target_bytes=512) if bucketed else None
    got, got_count = gradsync.psum_with_validity(_torch(grads),
                                                 torch.from_numpy(v), plan)
    assert float(got_count) == float(count[0]) == v.sum()
    for k in grads:
        assert bool(torch.isfinite(got[k]).all())
        _close(got[k], out[k][0])


def _ref_compressed(grads, plan_ref, residuals):
    def step(g, res):
        st = ref_gradsync.CompressionState(residuals=list(res))
        out, new = ref_gradsync.compressed_psum_mean(
            g, plan_ref, st, "w", jax.lax.axis_index("w"))
        return out, tuple(new.residuals)

    return jax.vmap(step, axis_name="w")(_jax(grads), tuple(residuals))


@pytest.mark.parametrize("workers,target", [(8, 1 << 20), (8, 700),
                                            (3, 512)])
def test_compressed_psum_and_residuals_match_the_reference(workers, target):
    """Two steps, the second fed the first's residuals (error feedback),
    at W = 8 (one bucket; several) and W = 3 (buckets padded to a
    multiple of W)."""
    grads = _per_worker(12 + workers, workers=workers)
    one = {k: v[0] for k, v in grads.items()}
    plan_ref = ref_gradsync.make_plan(_jax(one), target_bytes=target)
    plan = gradsync.make_plan(_torch(one), target_bytes=target)
    assert plan.starts == plan_ref.starts
    res_ref = [jnp.zeros((workers, plan.bucket_size(b)), jnp.float32)
               for b in range(plan.n_buckets)]
    state = gradsync.CompressionState.init(plan, workers)
    for _ in range(2):
        out_ref, res_ref = _ref_compressed(grads, plan_ref, res_ref)
        out, state = gradsync.compressed_psum_mean(_torch(grads), plan,
                                                   state, Runtime())
        for b, leaf_ids in enumerate(plan.bucket_leaves(b)
                                     for b in range(plan.n_buckets)):
            names = [sorted(grads)[i] for i in leaf_ids]
            mean = np.concatenate([np.asarray(out_ref[n][0]).reshape(-1)
                                   for n in names])
            step_size = np.abs(mean).max() / 127.0 + 1e-12
            for n in names:
                _close(out[n], out_ref[n][0], 1e-6 + 1.01 * step_size)
            _close(state.residuals[b], res_ref[b], 1e-6 + 1.01 * step_size)
        res_ref = list(res_ref)
    assert any(float(r.abs().max()) > 0 for r in state.residuals)


def test_compressed_without_state_is_the_fresh_reference_step():
    """``state=None`` is the reference train step's fresh zero state:
    the same mean, and no residuals kept."""
    grads = _per_worker(20)
    one = {k: v[0] for k, v in grads.items()}
    plan = gradsync.make_plan(_torch(one), target_bytes=1024)
    fresh, none = gradsync.compressed_psum_mean(_torch(grads), plan, None)
    kept, _ = gradsync.compressed_psum_mean(
        _torch(grads), plan, gradsync.CompressionState.init(plan, W))
    assert none is None
    for k in grads:
        assert torch.equal(fresh[k], kept[k])


def test_compressed_launches_one_quantize_and_dequantize_per_bucket():
    """Through the Runtime's kernel sites: the plain Runtime's callables
    see one (quantize, dequantize) pair per bucket, each with one block
    per worker shard."""
    grads = _per_worker(21, workers=4)
    one = {k: v[0] for k, v in grads.items()}
    plan = gradsync.make_plan(_torch(one), target_bytes=256)
    calls = []

    class Spy(Runtime):
        def op(self, name):
            fn = super().op(name)

            def spy(*args):
                calls.append((name, args[1] if name == "quantize"
                              else args[2]))
                return fn(*args)
            return spy

    gradsync.compressed_psum_mean(_torch(grads), plan, None,
                                  Spy(kernels="plain"))
    want = []
    for b in range(plan.n_buckets):
        shard = -(-plan.bucket_size(b) // 4)
        want += [("quantize", shard), ("dequantize", shard)]
    assert calls == want


# ---------------------------------------------------------------------------
# watermarks and what is not ported
# ---------------------------------------------------------------------------

def test_sync_state_monotone():
    s = gradsync.SyncState()
    s = s.advance().advance(null=True).deliver(1)
    assert s.sent_step == 2 and s.null_rounds == 1
    assert s.delivered_step == 1
    ref = ref_gradsync.SyncState().advance().advance(null=True).deliver(1)
    assert (s.sent_step, s.delivered_step, s.null_rounds) == \
        (ref.sent_step, ref.delivered_step, ref.null_rounds)
    with pytest.raises(ValueError):
        s.deliver(0)


def test_bucket_sync_stream_waits_for_the_cut():
    """A round applies once its buckets are delivered everywhere, and a
    cut that kills a contributor voids only that contributor: the same
    ledger as the reference's (tests/test_torch_elastic.py holds the
    elastic runtime)."""
    out = []
    for gs, view_cls in (
            (gradsync.BucketSyncStream([0, 1, 2], n_buckets=3, window=4,
                                       device="cpu"), views.View),
            (ref_gradsync.BucketSyncStream([0, 1, 2], n_buckets=3,
                                           window=4), ref_views.View)):
        pending = []
        for rnd in range(3):
            gs.contribute({m: {"w": float(m + rnd)} for m in (0, 1, 2)})
            pending.append(gs.applied_step)
        gs = gs.reconfigure(view_cls(vid=1, members=(0, 1),
                                     senders=(0, 1)))
        gs.contribute({0: {"w": 5.0}, 1: {"w": 6.0}})
        gs.finish()
        out.append((pending, [(a.step, a.contributors, a.voided,
                               a.update["w"]) for a in gs.applied]))
    assert out[0] == out[1]
    assert out[0][0][0] == 0                 # round 0 waits for delivery
    assert [a[0] for a in out[0][1]] == [0, 1, 2, 3]
