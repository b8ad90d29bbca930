"""Delivery predicate + total-order delivery (paper Secs. 2.4, 3.2, 3.5).

A message with seq ``s`` is deliverable once every subgroup member's
``received_num >= s``.  The Spindle delivery predicate takes the *minimum*
of the received_num column and delivers everything up to it in one batch,
in round-robin order.

The predicate functions work on torch tensors; the batch/log accounting
below them is host-side numpy over the traces a run copies back once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def stable_seq(received_num_column: torch.Tensor) -> torch.Tensor:
    """Highest seq received by *all* members (their received_num min).

    received_num_column: (n_members, ...) -> (...,)
    """
    return received_num_column.amin(dim=0)


def deliverable_range(delivered_num, received_num_column):
    """[lo, hi] inclusive seq range newly deliverable; empty if lo > hi."""
    hi = stable_seq(received_num_column)
    lo = delivered_num + 1
    return lo, hi


def _sender_counts_np(seq_prefix: int, n_senders: int) -> np.ndarray:
    """Per-sender counts in the first ``seq_prefix`` seqs (host-side
    :func:`repro_torch.core.sst.sender_counts`)."""
    return seq_prefix // n_senders + (np.arange(n_senders)
                                      < seq_prefix % n_senders)


@dataclasses.dataclass
class DeliveryBatch:
    """A resolved batch of deliverable messages in delivery order."""

    lo_seq: int
    hi_seq: int
    n_senders: int

    def __len__(self) -> int:
        return max(0, self.hi_seq - self.lo_seq + 1)

    def messages(self):
        """Yield (seq, sender_rank, sender_index) in delivery order."""
        for s in range(self.lo_seq, self.hi_seq + 1):
            yield s, s % self.n_senders, s // self.n_senders


def split_app_and_null(batch: DeliveryBatch, is_app) -> tuple:
    """Count (application, null) messages in a delivery batch.

    is_app[rank] is a per-sender boolean sequence over publish indexes
    (True = application payload, False = null).  Indexes past a sender's
    log (published-but-untracked tail) count as nulls.  The batch's
    [lo, hi] seq range decomposes into one contiguous per-sender index
    range via the round-robin count arithmetic, so no per-message loop.
    """
    total = len(batch)
    if total == 0:
        return 0, 0
    lo_counts = _sender_counts_np(batch.lo_seq, batch.n_senders)
    hi_counts = _sender_counts_np(batch.hi_seq + 1, batch.n_senders)
    n_app = sum(
        int(np.count_nonzero(np.asarray(is_app[r], dtype=bool)
                             [int(lo_counts[r]):int(hi_counts[r])]))
        for r in range(batch.n_senders))
    return n_app, total - n_app


def apps_in_publish_prefix(app_pub, nulls, n_publishes) -> int:
    """Application messages among one sender's first ``n_publishes``
    publishes, given its per-round publish trace.

    app_pub/nulls: (T,) per-round app/null publish counts for ONE sender
    rank.  Within a round a sender publishes its apps before its nulls
    (matching :func:`repro_torch.core.sweep.sweep`'s
    ``published + app_pub + nulls``).  This is the per-sender half of the
    virtual-synchrony cut (DESIGN.md Sec. 7).
    """
    app_pub = np.asarray(app_pub, dtype=np.int64)
    nulls = np.asarray(nulls, dtype=np.int64)
    total = app_pub + nulls
    before = np.cumsum(total) - total            # exclusive prefix
    taken = np.clip(n_publishes - before, 0, app_pub)
    return int(taken.sum())
