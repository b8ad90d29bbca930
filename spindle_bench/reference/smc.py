"""The plain reference of the multicast: Derecho's SMC protocol on one
subgroup, round by round, in ``numpy``.

Each round every node runs its predicates once over what it sees of the
shared state table, and what a node writes becomes visible to the others
one round later:

* receive: a node takes every publish it sees; its ``received_num`` is
  the last sequence number of the round-robin order it holds without a
  gap (sequence ``i * S + s`` is sender ``s``'s ``i``-th publish);
* null: a sender with nothing to send publishes the nulls that bring its
  next index up to the first that does not precede the latest message it
  received from any other sender;
* send: a sender publishes its queued messages as far as its ring
  window allows: ``window`` beyond its own publishes that every member
  is seen to have delivered;
* delivery: a node delivers up to the least ``received_num`` it sees
  over all members (its own counted as it is now).

Messages the window holds back stay queued, first in first out.  The
control ``stability=False`` breaks the stability guarantee: each node
delivers what it has received, without waiting for the others.
"""

from __future__ import annotations

import numpy as np


def rr_prefix(counts: np.ndarray) -> np.ndarray:
    """Rows of per-sender counts -> how many messages of the round-robin
    order each row holds without a gap: every sender's ``min`` of the
    row, then the leading senders that hold one more."""
    s = counts.shape[-1]
    full = counts.min(axis=-1)
    return full * s + np.argmin(counts > full[..., None], axis=-1)


def own_count(seq_prefix, rank, s: int):
    """How many of sender ``rank``'s messages the first ``seq_prefix``
    of the round-robin order hold."""
    return seq_prefix // s + (rank < seq_prefix % s)


def simulate(arrivals: np.ndarray, n_members: int, window: int, *,
             stability: bool = True):
    """``arrivals`` ``(T, S)`` released messages a sender a round ->
    ``(batches (T, N), app_pub (T, S), nulls (T, S), backlog (S,))``:
    per round the messages each member delivered and each sender
    published.  Sender ``i`` is member ``i``."""
    t_n, s = arrivals.shape
    n = n_members
    ranks = np.arange(s)
    other = ~np.eye(s, dtype=bool)
    later = np.triu(np.ones((s, s), np.int64), 1)     # 1 where i < j
    published = np.zeros(s, np.int64)
    pub_vis = np.zeros((n, s), np.int64)
    recv = np.zeros((n, s), np.int64)
    received = np.full(n, -1, np.int64)
    recv_vis = np.full((n, n), -1, np.int64)
    delivered = np.full(n, -1, np.int64)
    deliv_vis = np.full((n, n), -1, np.int64)
    backlog = np.zeros(s, np.int64)
    batches = np.zeros((t_n, n), np.int64)
    app_pub = np.zeros((t_n, s), np.int64)
    nulls = np.zeros((t_n, s), np.int64)
    for t in range(t_n):
        want = backlog + arrivals[t]
        recv = np.maximum(recv, pub_vis)
        received = np.maximum(received, rr_prefix(recv) - 1)
        # null: up to the first index not before the latest message
        # received from any other sender
        rs = recv[:s]
        target = np.where(other & (rs > 0), rs - 1 + later, 0).max(axis=1)
        null_t = np.where(want == 0, np.maximum(target - published, 0), 0)
        # send: a window beyond what every member is seen to deliver
        seen = deliv_vis[:s].copy()
        seen[ranks, ranks] = delivered[:s]
        cap = own_count(seen.min(axis=1) + 1, ranks, s) + window
        app_t = np.minimum(want, np.maximum(cap - published, 0))
        published = published + app_t + null_t
        recv[ranks, ranks] = np.maximum(recv[ranks, ranks], published)
        received = np.maximum(received, rr_prefix(recv) - 1)
        seen = recv_vis.copy()
        np.fill_diagonal(seen, received)
        stable = seen.min(axis=1) if stability else received
        new = np.maximum(delivered, stable)
        batches[t] = new - delivered
        app_pub[t], nulls[t] = app_t, null_t
        delivered = new
        pub_vis = np.maximum(pub_vis, published[None, :])
        recv_vis = np.maximum(seen, received[None, :])
        deliv_vis = np.maximum(deliv_vis, delivered[None, :])
        backlog = want - app_t
    return batches, app_pub, nulls, backlog


def apps_everywhere(batches: np.ndarray, app_pub: np.ndarray,
                    nulls: np.ndarray) -> np.ndarray:
    """``(T,)`` application messages delivered at every member by the
    end of each round, from the rounds' delivered counts and publishes
    (apps before nulls within a sender's round)."""
    s = app_pub.shape[1]
    seqs = np.cumsum(batches, axis=0).min(axis=1)
    pubs = np.cumsum(app_pub + nulls, axis=0)
    apps = np.cumsum(app_pub, axis=0)
    out = np.zeros(seqs.shape, np.int64)
    for r in range(s):
        k = own_count(seqs, r, s)
        u = np.minimum(np.searchsorted(pubs[:, r], k), len(k) - 1)
        before = pubs[u, r] - app_pub[u, r] - nulls[u, r]
        out += apps[u, r] - app_pub[u, r] + np.minimum(app_pub[u, r],
                                                        k - before)
    return out
