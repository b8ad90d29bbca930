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
unstacked (each leaf ``shape``).  :class:`BucketSyncStream` routes a
bucket reduction through a live multicast stream, so that an elastic
resize crosses the virtual-synchrony cut.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch import tree as tree_util
from repro_torch.core import delivery as delivery_mod
from repro_torch.core import group as group_mod
from repro_torch.core import simulator as sim
from repro_torch.models.runtime import Runtime

PyTree = Any


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

@dataclasses.dataclass(frozen=True)
class AppliedRound:
    """One optimizer round applied in delivery order.

    ``contributors`` are the nodes whose full bucket set went stable (the
    round's mean is over exactly these); ``voided`` are dead contributors
    whose buckets died beyond their final stable watermark — the
    null-round rescaling of :func:`psum_with_validity`, applied at the
    cut instead of at publish time.  ``update`` is the mean over
    contributors' update trees (None when every contributor voided).
    """

    step: int
    contributors: Tuple[int, ...]
    voided: Tuple[int, ...] = ()
    update: Any = None


class BucketSyncStream:
    """Bucket reduction routed through a live multicast
    :class:`~repro_torch.core.group.GroupStream`, so an elastic-training
    view change exercises the SAME wedge / ragged trim /
    :class:`~repro_torch.core.group.EpochCarry` algorithm as the stream
    and serve planes (DESIGN.md Sec. 7).

    Mapping: workers are the one subgroup's members AND senders; one
    optimizer round = one :meth:`contribute` call publishing
    ``n_buckets`` app messages per contributing worker (one message per
    fused bucket).  A round's update applies — identically at every
    worker, in ledger (total) order — once every contributor's full
    bucket set is DELIVERED at every member, read off the stream's
    delivery watermark exactly like a serve slot release.  Across a view
    change the cut decides each in-flight round: a surviving
    contributor's unstable buckets ride the resend backlog into the new
    view (the round applies later, unchanged); a FAILED contributor's
    unstable tail dies with it and the round applies with that
    contribution voided — the mean rescales over the survivors.
    ``app_base`` stays monotone per worker across consecutive cuts, so
    the applied watermark never rolls back.

    The stream runs on ``backend`` (``"kernel"``: one receive-kernel
    launch a round; ``"des"``: the numpy round mirror on the host) on
    ``device`` (the GPU unless ``"cpu"`` is named);
    the update mean is computed where the contributions are.  Duck-types
    the stream side of
    :meth:`repro_torch.core.views.MembershipService.reconfigure_stream`
    (``reconfigure(view)``), which is how
    :class:`repro_torch.train.elastic.ElasticRuntime` drives it.
    """

    def __init__(self, members: Sequence[int], *, n_buckets: int,
                 window: int = 8, backend: str = "kernel",
                 msg_size: int = 1 << 20, device: DeviceLike = None):
        if n_buckets < 1:
            raise ValueError("need at least one bucket per round")
        members = tuple(sorted(members))
        self.n_buckets = int(n_buckets)
        self.backend = backend
        spec = sim.SubgroupSpec(members=members, senders=members,
                                msg_size=msg_size, window=window,
                                n_messages=0)
        cfg = group_mod.GroupConfig(members=members, subgroups=(spec,))
        self._stream = group_mod.Group(cfg, device=device).stream(
            backend=backend)
        # cumulative (cross-epoch) per-node app accounting: enq = buckets
        # ever contributed, base = stable at the last cut, dead = a dead
        # node's final deliverable cap (its stable count at its cut)
        self._enq: Dict[int, int] = {m: 0 for m in members}
        self._base: Dict[int, int] = {m: 0 for m in members}
        self._dead: Dict[int, int] = {}
        # FIFO ledger of pending rounds: {"step", "targets": {node:
        # cumulative enq after this round}, "updates": {node: tree}}
        self._ledger: List[Dict[str, Any]] = []
        self._next_step = 0
        self.applied: List[AppliedRound] = []

    # -- introspection -------------------------------------------------------

    @property
    def members(self) -> Tuple[int, ...]:
        return self._stream.group.cfg.subgroups[0].members

    @property
    def _senders(self) -> Tuple[int, ...]:
        return self._stream.group.cfg.subgroups[0].senders

    @property
    def applied_step(self) -> int:
        """Rounds applied everywhere — the monotone watermark the
        elastic runtime exposes as every live worker's
        ``delivered_step``."""
        return len(self.applied)

    @property
    def group(self):
        return self._stream.group

    # -- the contribution plane ---------------------------------------------

    def contribute(self, contributions: Mapping[int, PyTree]) -> None:
        """One optimizer round: each contributing worker publishes its
        ``n_buckets`` bucket messages.  Workers absent from
        ``contributions`` publish nothing this round (nulls cover their
        ranks — the straggler case); an empty mapping is a pure drain
        round that only advances delivery.  Newly applied rounds land in
        :attr:`applied` (see :meth:`poll`)."""
        senders = self._senders
        rank = {m: r for r, m in enumerate(senders)}
        g, s_max = self._stream.shape
        ready = np.zeros((g, s_max), np.int64)
        targets: Dict[int, int] = {}
        updates: Dict[int, PyTree] = {}
        for node in sorted(contributions):
            if node not in rank:
                raise ValueError(
                    f"node {node} is not a live member of the current "
                    "view (dead contributors cannot publish)")
            ready[0, rank[node]] = self.n_buckets
            self._enq[node] += self.n_buckets
            targets[node] = self._enq[node]
            updates[node] = contributions[node]
        if targets:
            self._ledger.append({"step": self._next_step,
                                 "targets": targets, "updates": updates})
            self._next_step += 1
        self._stream.step(ready)
        self.poll()

    def _delivered_apps(self) -> Dict[int, int]:
        """Cumulative app messages delivered everywhere per node: the
        cross-epoch base plus the current epoch's in-protocol apps (the
        delivery watermark converted through the publish traces, apps
        before nulls — the same arithmetic as the cut's stable count)."""
        out = dict(self._dead)
        senders = self._senders
        d = self._stream.view().sender_delivered(0)
        if self._stream.rounds:
            _, app_pub, nulls = self._stream.traces()
        for r, node in enumerate(senders):
            apps = 0
            if self._stream.rounds:
                apps = delivery_mod.apps_in_publish_prefix(
                    app_pub[0, :, r], nulls[0, :, r], int(d[r]))
            out[node] = self._base[node] + apps
        return out

    def poll(self) -> List[AppliedRound]:
        """Apply every head-of-ledger round whose contributors are all
        accounted for — delivered everywhere, or dead with the target
        beyond their final stable cap (voided).  Rounds apply strictly
        in ledger order: the multicast total order IS the optimizer
        order.  The update is ``sum(xs) / len(xs)`` leaf by leaf over the
        contributors in ledger order, on the contributions' device.
        Returns the newly applied rounds."""
        newly: List[AppliedRound] = []
        delivered = self._delivered_apps()
        while self._ledger:
            head = self._ledger[0]
            voided, pending = [], False
            for node, tgt in head["targets"].items():
                if delivered.get(node, 0) >= tgt:
                    continue              # full bucket set stable
                if node in self._dead:
                    voided.append(node)   # tail died at the cut
                    continue
                pending = True
                break
            if pending:
                break
            contributors = tuple(n for n in head["targets"]
                                 if n not in voided)
            update = None
            if contributors:
                trees = [head["updates"][n] for n in contributors]
                update = tree_util.map(
                    lambda *xs: sum(xs) / len(xs), *trees)
            newly.append(AppliedRound(step=head["step"],
                                      contributors=contributors,
                                      voided=tuple(sorted(voided)),
                                      update=update))
            self._ledger.pop(0)
        self.applied.extend(newly)
        return newly

    # -- the cut --------------------------------------------------------------

    def reconfigure(self, view) -> "BucketSyncStream":
        """Carry the reduction across a virtual-synchrony cut.

        The inner stream wedges and trims exactly as any stream
        (:meth:`~repro_torch.core.group.GroupStream.reconfigure`):
        survivors' unstable buckets become resend backlog, their
        ``app_base`` advances by what went stable, and a dead worker's
        stable count at the cut (the closing report's
        ``stable_apps_by_old_rank``) becomes its final deliverable CAP:
        ledger rounds needing more than the cap apply with that
        contribution voided.  Joiners in ``view`` become senders of the
        new epoch with zero base and backlog (``Group.reconfigure`` only
        shrinks subgroups, so the joined epoch's group is rebuilt here
        with the carry expanded onto the wider rank space).  Mutates in
        place and returns ``self``."""
        old_senders = self._senders
        old_stream = self._stream
        new_stream = old_stream.reconfigure(view)
        vc = old_stream.group.last_report.extras["view_change"]
        stable_old = vc["stable_apps_by_old_rank"][0]
        alive = set(view.members)
        for old_rank, node in enumerate(old_senders):
            cum_stable = self._base[node] + int(stable_old[old_rank])
            self._base[node] = cum_stable
            if node not in alive:
                self._dead[node] = cum_stable
        joiners = [m for m in view.members
                   if m not in self._enq and m not in self._dead]
        for m in joiners:
            self._enq[m] = self._base[m] = 0
        if joiners:
            surv_group = new_stream.group
            carry = surv_group.carry
            surv_senders = surv_group.cfg.subgroups[0].senders
            spec = surv_group.cfg.subgroups[0]
            all_members = tuple(sorted(set(spec.members) | set(joiners)))
            cfg = dataclasses.replace(
                surv_group.cfg, members=all_members,
                subgroups=(dataclasses.replace(spec, members=all_members,
                                               senders=all_members),))
            expanded = group_mod.Group(cfg, device=surv_group.device)
            k = len(all_members)
            resend = np.zeros(k, np.int64)
            stb = np.zeros(k, np.int64)
            base = np.zeros(k, np.int64)
            pos = {m: i for i, m in enumerate(all_members)}
            for r, node in enumerate(surv_senders):
                resend[pos[node]] = carry.resend[0][r]
                stb[pos[node]] = carry.stable_apps[0][r]
                base[pos[node]] = carry.app_base[0][r]
            expanded.carry = group_mod.EpochCarry(
                from_epoch=carry.from_epoch, cut_seq=carry.cut_seq,
                resend=(resend,), stable_apps=(stb,), app_base=(base,))
            new_stream = expanded.stream(backend=new_stream.backend)
        self._stream = new_stream
        # the cut may itself have advanced delivery to the trim
        self.poll()
        return self

    def finish(self):
        """Drain the stream to quiescence and apply every remaining
        ledger round.  Returns the final epoch's
        :class:`~repro_torch.core.group.RunReport`."""
        report, _logs = self._stream.finish()
        self.poll()
        assert not self._ledger, (
            "quiescent stream left unapplied rounds: a live "
            "contributor's buckets never delivered")
        return report


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
