"""Spindle-style gradient synchronization — the paper's techniques on the
data-parallel reduction of a training step.

The port of ``repro.core.gradsync`` (DESIGN.md Sec. 2):

* **Opportunistic batching** -> *fused gradient buckets*: every ready
  gradient is coalesced into a few large buckets, each reduced at once
  (:func:`fused_psum_mean`) instead of one reduction per tensor
  (:func:`per_tensor_psum_mean`, the per-event baseline).  A bucket
  closes when it reaches ``target_bytes``; the bucket order is the
  deterministic leaf order.
* **Null-sends** -> *null rounds*: a worker with no gradient this round
  contributes an explicit zero with a validity flag, and the mean is
  over the live count (:func:`psum_with_validity`).
* **Compression** (beyond the paper): reduce-scatter in float32,
  int8-quantize each worker's shard, all-gather the int8 shards, with
  error-feedback residuals (:func:`compressed_psum_mean`).  The quantize
  and dequantize steps are kernel sites (``rt.op("quantize")``), with
  one block per worker shard — the reference's ``_quantize_int8``, one
  scale per shard.

The reference runs these inside ``shard_map`` over a mesh axis.  One card
serves here, so the W data-parallel workers are a leading tensor
dimension of every leaf: the functions take *stacked* gradients, each
leaf ``(W, *shape)``, worker ``w``'s gradient at index ``w``.  The
collectives become tensor operations on that dimension: ``psum`` is a
sum over dim 0; ``psum_scatter`` of a ``(W, L)`` bucket is a reshape to
``(W, W, L / W)`` followed by a sum over dim 0 (worker ``j`` owns row
``j`` of the result); ``all_gather`` is the identity of that gathered
layout.  A mean is the same on every worker, so it comes back once,
unstacked (each leaf ``shape``).  ``BucketSyncStream`` (bucket reduction
through the multicast cut) comes with the cut, ROADMAP item 5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.models.runtime import Runtime

PyTree = Any

CUT_ITEM = "ROADMAP.md item 5 (the virtual-synchrony cut)"


# ---------------------------------------------------------------------------
# Bucket plan — the SMC "ring slots" of the gradient plane
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A static partition of a gradient tree into contiguous buckets."""

    like: PyTree                       # the tree's structure (leaves None)
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[torch.dtype, ...]
    leaf_sizes: Tuple[int, ...]
    # bucket b covers leaves [starts[b], starts[b+1])
    starts: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.starts) - 1

    def bucket_leaves(self, b: int) -> range:
        return range(self.starts[b], self.starts[b + 1])

    def bucket_size(self, b: int) -> int:
        """Elements of bucket ``b``."""
        return sum(self.leaf_sizes[i] for i in self.bucket_leaves(b))

    def bucket_bytes(self, b: int) -> int:
        return sum(self.leaf_sizes[i] * self.leaf_dtypes[i].itemsize
                   for i in self.bucket_leaves(b))


def make_plan(tree: PyTree,
              target_bytes: int = 32 * 1024 * 1024) -> BucketPlan:
    """Greedy bucketization in deterministic leaf order (the delivery
    order): a bucket closes as soon as it reaches ``target_bytes`` —
    opportunistic, never waiting for a "full" batch.  ``tree`` holds one
    worker's gradients (or anything with their shapes and dtypes)."""
    leaves = tree_util.leaves(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    starts = [0]
    acc = 0
    for i in range(len(leaves)):
        acc += sizes[i] * dtypes[i].itemsize
        if acc >= target_bytes:
            starts.append(i + 1)
            acc = 0
    if starts[-1] != len(leaves):
        starts.append(len(leaves))
    return BucketPlan(like=tree_util.map(lambda _: None, tree),
                      leaf_shapes=shapes, leaf_dtypes=dtypes,
                      leaf_sizes=sizes, starts=tuple(starts))


def _lead(leaf: torch.Tensor, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The leading dims of a (possibly stacked) leaf ahead of ``shape``."""
    lead = tuple(leaf.shape[:leaf.dim() - len(shape)])
    if tuple(leaf.shape[len(lead):]) != shape:
        raise ValueError(f"leaf {tuple(leaf.shape)} does not end in the "
                         f"plan's {shape}")
    return lead


def flatten_buckets(grads: PyTree, plan: BucketPlan) -> List[torch.Tensor]:
    """Each bucket as one flat buffer in the leaves' dtype: ``(L_b,)`` for
    one worker's tree, ``(W, L_b)`` for a stacked one.  A one-leaf bucket
    is a view of its leaf."""
    leaves = tree_util.leaves(grads)
    if len(leaves) != len(plan.leaf_sizes):
        raise ValueError("plan/tree mismatch")
    out = []
    for b in range(plan.n_buckets):
        parts = []
        for i in plan.bucket_leaves(b):
            lead = _lead(leaves[i], plan.leaf_shapes[i])
            parts.append(leaves[i].reshape(*lead, -1))
        out.append(torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0])
    return out


def _bucket_leaves(buf: torch.Tensor, plan: BucketPlan,
                   b: int) -> List[torch.Tensor]:
    """Bucket ``b``'s leaves cut from its flat buffer (``(..., L_b)``),
    each in its plan dtype."""
    lead = tuple(buf.shape[:-1])
    out, off = [], 0
    for i in plan.bucket_leaves(b):
        n = plan.leaf_sizes[i]
        out.append(buf[..., off:off + n].reshape(*lead, *plan.leaf_shapes[i])
                   .to(plan.leaf_dtypes[i]))
        off += n
    return out


def unflatten_buckets(buckets: Sequence[torch.Tensor],
                      plan: BucketPlan) -> PyTree:
    """The inverse of :func:`flatten_buckets`; each leaf back in its
    plan dtype."""
    leaves = []
    for b, buf in enumerate(buckets):
        leaves += _bucket_leaves(buf, plan, b)
    return tree_util.unflatten(plan.like, leaves)


# ---------------------------------------------------------------------------
# Reduction modes (stacked (W, ...) leaves in, one mean out)
# ---------------------------------------------------------------------------

def _workers(grads: PyTree) -> int:
    return tree_util.leaves(grads)[0].shape[0]


def per_tensor_psum_mean(grads: PyTree) -> PyTree:
    """Baseline: one reduction per tensor (the per-event ack analogue)."""
    n = _workers(grads)
    return tree_util.map(lambda g: g.sum(0) / n, grads)


def fused_psum_mean(grads: PyTree, plan: BucketPlan) -> PyTree:
    """Spindle: opportunistic fused-bucket reduction — every ready
    gradient coalesced, one reduction per bucket."""
    n = _workers(grads)
    buckets = flatten_buckets(grads, plan)
    return unflatten_buckets([b.sum(0) / n for b in buckets], plan)


def psum_with_validity(grads: PyTree, valid: torch.Tensor,
                       plan: Optional[BucketPlan] = None
                       ) -> Tuple[PyTree, torch.Tensor]:
    """Null-round elastic reduction: stragglers (``valid[w] == 0``)
    contribute a zeroed gradient, and the mean is over the live
    contributors only.  ``valid`` (W,).  Returns (mean, live_count)."""
    valid_f = valid.to(torch.float32)
    count = valid_f.sum()
    denom = torch.clamp(count, min=1.0)

    def mask(g):
        v = valid_f.to(g.dtype).reshape(-1, *([1] * (g.dim() - 1)))
        return g * v

    masked = tree_util.map(mask, grads)
    if plan is None:
        summed = tree_util.map(lambda g: g.sum(0), masked)
    else:
        summed = unflatten_buckets(
            [b.sum(0) for b in flatten_buckets(masked, plan)], plan)
    return tree_util.map(lambda g: g / denom.to(g.dtype), summed), count


# ---------------------------------------------------------------------------
# int8 compressed reduction with error feedback (beyond the paper)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionState:
    """Error-feedback residuals, one ``(W, L_b)`` float32 buffer per
    bucket: worker ``w``'s residual of bucket ``b`` at row ``w``."""

    residuals: List[torch.Tensor]

    @classmethod
    def init(cls, plan: BucketPlan, workers: int,
             device=None) -> "CompressionState":
        return cls(residuals=[
            torch.zeros((workers, plan.bucket_size(b)), dtype=torch.float32,
                        device=device)
            for b in range(plan.n_buckets)])


def compressed_psum_mean(grads: PyTree, plan: BucketPlan,
                         state: Optional[CompressionState],
                         rt: Runtime = Runtime()
                         ) -> Tuple[PyTree, Optional[CompressionState]]:
    """reduce_scatter (float32) -> int8-quantize each worker's shard ->
    all_gather (int8), with error feedback: a worker's residual (what
    quantizing its shard lost) is added to its gradient next step.

    Per bucket of L elements (padded to a multiple of W), one
    ``rt.op("quantize")`` launch quantizes all W shards with one scale
    per shard (``block = padded L / W``), and one ``rt.op("dequantize")``
    launch rebuilds the gathered bucket.

    ``state`` None is the zero state of a fresh step whose residuals are
    not kept — what the reference's train step does (it builds
    ``CompressionState.init`` inside every step and discards the new
    residuals) — and then None comes back; no residual buffer is
    allocated.  Otherwise the new residuals come back as a
    :class:`CompressionState`."""
    w = _workers(grads)
    quantize, dequantize = rt.op("quantize"), rt.op("dequantize")
    buckets = flatten_buckets(grads, plan)
    leaves, new_res = [], []
    for b in range(plan.n_buckets):
        buf = buckets[b].float()
        buckets[b] = None             # free a concatenated bucket early
        if state is not None:
            buf = buf + state.residuals[b]
        length = buf.shape[1]
        pad = (-length) % w
        if pad:
            buf = torch.nn.functional.pad(buf, (0, pad))
        shard_len = buf.shape[1] // w
        # reduce_scatter: worker j owns the sum of every worker's shard j
        shard = buf.reshape(w, w, shard_len).sum(0) / w
        del buf
        q, scales = quantize(shard.reshape(-1), shard_len)
        # all_gather of the int8 shards and their scales, dequantized
        full = dequantize(q, scales, shard_len, torch.float32)
        del q
        if state is not None:
            # worker j's residual is nonzero on its own shard only
            err = shard - full.view(w, shard_len)
            res = torch.zeros((w, w, shard_len), dtype=torch.float32,
                              device=err.device)
            res[torch.arange(w), torch.arange(w)] = err
            new_res.append(res.view(w, -1)[:, :length])
        del shard
        leaves += _bucket_leaves(full[:length], plan, b)
        del full
    mean = tree_util.unflatten(plan.like, leaves)
    return mean, (CompressionState(residuals=new_res)
                  if state is not None else None)


# ---------------------------------------------------------------------------
# The multicast-routed stream and the SyncState watermarks
# ---------------------------------------------------------------------------

class BucketSyncStream:
    """Bucket reduction routed through a live multicast stream, so that an
    elastic view change crosses the virtual-synchrony cut.  Not ported
    yet: it exists to cross a view change, which comes with the cut."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"BucketSyncStream crosses view changes; it comes with {CUT_ITEM}")


@dataclasses.dataclass
class SyncState:
    """Per-worker monotonic counters mirrored via the SST pattern.

    ``sent_step``      — rounds this worker contributed (app or null),
    ``delivered_step`` — last optimizer step applied everywhere (the
                         checkpoint watermark: restore resumes here),
    ``null_rounds``    — rounds filled with a null contribution.
    """

    sent_step: int = 0
    delivered_step: int = 0
    null_rounds: int = 0

    def advance(self, *, null: bool = False) -> "SyncState":
        return SyncState(self.sent_step + 1, self.delivered_step,
                         self.null_rounds + (1 if null else 0))

    def deliver(self, step: int) -> "SyncState":
        if step < self.delivered_step:
            raise ValueError("delivered_step must be monotonic")
        return SyncState(self.sent_step, step, self.null_rounds)
