"""The null-send scheme (paper Sec. 3.3) over torch tensors.

Rule: *when a sender node receives a message, it sends a single null iff
that null (its own next message, M(i, l)) would precede the received
message M(j, k) in the delivery order*:

    send null  <=>  l < k  or  (l == k and i < j)

Batched form: bring the own next index ``l`` up to the first value that
does NOT precede the latest received message:

    target(i | j, k) = k + 1 if i < j else k

Both helpers dispatch on the input type, as the reference does: torch
when an input is a ``torch.Tensor``, else the reference's numpy
expression (the discrete-event simulator calls them per event).
"""

from __future__ import annotations

import numpy as np
import torch


def precedes(k1, i1, k2, i2):
    """M(i1,k1) < M(i2,k2) in round-robin delivery order."""
    return (k1 < k2) | ((k1 == k2) & (i1 < i2))


def null_target(own_rank, recv_index, recv_rank):
    """Smallest own next-index l such that M(own_rank, l) does not precede
    M(recv_rank, recv_index).  The torch form keeps ``recv_index``'s
    dtype."""
    if not any(isinstance(x, torch.Tensor)
               for x in (own_rank, recv_index, recv_rank)):
        return recv_index + np.where(np.asarray(own_rank) < recv_rank, 1, 0)
    recv_index = torch.as_tensor(recv_index)
    before = torch.as_tensor(own_rank) < torch.as_tensor(recv_rank)
    return recv_index + before.to(recv_index.dtype)


def nulls_needed(own_rank, own_next_index, recv_counts):
    """Batched null-send decision after one receiver-predicate iteration.

    own_next_index: l = number of messages this node has sent (app + null).
    recv_counts: (..., S) per-sender received counts; the latest received
    message from s is M(s, recv_counts[s]-1).  Returns the number of nulls
    to publish now; zero when nothing was received or we are caught up.
    """
    if not isinstance(recv_counts, torch.Tensor):
        recv_counts = np.asarray(recv_counts)
        s = recv_counts.shape[-1]
        ranks = np.arange(s)
        have = recv_counts > 0
        tgt = null_target(own_rank, recv_counts - 1, ranks)
        tgt = np.where(have, tgt, 0)
        tgt = np.where(ranks == own_rank, 0, tgt)
        target = np.max(tgt, axis=-1)
        return np.maximum(target - own_next_index, 0)
    s = recv_counts.shape[-1]
    ranks = torch.arange(s, device=recv_counts.device)
    tgt = null_target(own_rank, recv_counts - 1, ranks)
    tgt = torch.where(recv_counts > 0, tgt, 0)
    # Never respond to our own messages.
    tgt = torch.where(ranks == own_rank, 0, tgt)
    return torch.clamp(tgt.amax(dim=-1) - own_next_index, min=0)
