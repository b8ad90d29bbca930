"""SST round-robin arithmetic (paper Secs. 2.1-2.2) over torch tensors.

The Shared State Table holds each node's monotone protocol counters;
merging any stale/fresh mixture of copies with elementwise ``max`` is
always safe.  This module keeps the sequence arithmetic the fused sweep
and the delivery logs are built on.  Every function keeps the dtype of
its input: torch's ``cumprod``/``sum`` on int32 would return int64, so
each reduction names its dtype.

The four round-robin helpers dispatch on the input type, as the
reference does: a ``torch.Tensor`` takes the torch form, anything else
(numpy arrays, Python ints) the reference's numpy expression.  The
discrete-event simulator calls them per event on numpy arrays, where a
torch op's dispatch cost would dominate.

Messages are M(i, k): sender rank i, sender index k.  Total order:
``M(i1,k1) < M(i2,k2)  <=>  k1 < k2 or (k1 == k2 and i1 < i2)``, and
``seq_num(i, k) = k * n_senders + i``.
"""

from __future__ import annotations

import numpy as np
import torch


def seq_of(rank, index, n_senders: int):
    return index * n_senders + rank


def rank_of(seq, n_senders: int):
    return seq % n_senders


def index_of(seq, n_senders: int):
    return seq // n_senders


def _leading_run(ge: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Length of the run of True from index 0 along the last axis."""
    run = torch.cumprod(ge.to(dtype), dim=-1, dtype=dtype)
    return run.sum(dim=-1, dtype=dtype)


def rr_prefix(counts):
    """Highest N such that the first N messages of the round-robin order
    are all present, given per-sender received counts.

    counts: (..., S) integer tensor or array; returns (...) of the same
    dtype.
    ``received_num`` (a seq number) is then ``rr_prefix(counts) - 1``.
    """
    if not isinstance(counts, torch.Tensor):
        m = np.min(counts, axis=-1, keepdims=True)
        ge = counts >= (m + 1)
        run = np.cumprod(ge.astype(counts.dtype), axis=-1)
        extra = np.sum(run, axis=-1)
        s = counts.shape[-1]
        return np.squeeze(m, -1) * s + extra
    m = counts.amin(dim=-1, keepdim=True)                # complete rounds
    extra = _leading_run(counts >= m + 1, counts.dtype)  # can extend round m
    return m.squeeze(-1) * counts.shape[-1] + extra


def rr_prefix_masked(counts, mask, s_eff):
    """:func:`rr_prefix` over the masked prefix of the sender axis.

    counts: (..., S) integer; mask: bool broadcastable to counts, True on
    the first ``s_eff`` slots; s_eff: int or tensor broadcastable to
    ``counts.shape[:-1]``.  Padded slots never extend the prefix and
    never hold it back.  The int-max sentinel of an all-padded row wraps
    on ``+ 1`` exactly as the reference's int32 arithmetic does.
    """
    if not isinstance(counts, torch.Tensor):
        counts = np.asarray(counts)
        mask = np.asarray(mask)
        big = np.iinfo(counts.dtype).max
        m = np.min(np.where(mask, counts, big), axis=-1, keepdims=True)
        ge = (counts >= m + 1) & mask
        run = np.cumprod(ge.astype(counts.dtype), axis=-1)
        extra = np.sum(run, axis=-1)
        return np.squeeze(m, -1) * s_eff + extra
    big = torch.iinfo(counts.dtype).max
    m = torch.where(mask, counts, big).amin(dim=-1, keepdim=True)
    extra = _leading_run((counts >= m + 1) & mask, counts.dtype)
    return m.squeeze(-1) * s_eff + extra


def sender_counts(seq_prefix, n_senders: int):
    """Inverse-ish of rr_prefix: per-sender message counts contained in the
    first ``seq_prefix`` messages of the round-robin order."""
    if not isinstance(seq_prefix, torch.Tensor):
        seq_prefix = np.asarray(seq_prefix)
        full = seq_prefix[..., None] // n_senders
        rem = seq_prefix[..., None] % n_senders
        ranks = np.arange(n_senders)
        return full + (ranks < rem)
    full = seq_prefix[..., None] // n_senders
    rem = seq_prefix[..., None] % n_senders
    ranks = torch.arange(n_senders, device=seq_prefix.device)
    return full + (ranks < rem)


def sender_counts_masked(seq_prefix, s_eff, n_slots: int):
    """:func:`sender_counts` with a per-row effective sender count
    (``s_eff``: int or tensor broadcastable to ``seq_prefix``), padded to
    ``n_slots`` columns (entries at ranks >= s_eff are meaningless and
    must be masked by the caller).  A numpy ``seq_prefix`` takes the
    reference's form, with a scalar ``s_eff``."""
    if not isinstance(seq_prefix, torch.Tensor):
        seq_prefix = np.asarray(seq_prefix)
        full = seq_prefix[..., None] // s_eff
        rem = seq_prefix[..., None] % s_eff
        ranks = np.arange(n_slots)
        return full + (ranks < rem)
    if isinstance(s_eff, torch.Tensor):
        s_eff = s_eff[..., None]
    full = seq_prefix[..., None] // s_eff
    rem = seq_prefix[..., None] % s_eff
    ranks = torch.arange(n_slots, device=seq_prefix.device)
    return full + (ranks < rem)


# -- host-side cut arithmetic (numpy, as in the reference) -------------------

def ragged_trim(received_num, alive) -> int:
    """The virtual-synchrony cut seq (paper Secs. 2.1, 3.3; DESIGN.md
    Sec. 7): the highest seq received by EVERY surviving member.

    received_num: (N,) per-member rr-prefix seq watermarks; alive: (N,)
    bool, True for members of the next view.  With no survivors the trim
    is -1.  Host-side: accepts numpy arrays or CPU tensors.
    """
    received_num = np.asarray(received_num)
    alive = np.asarray(alive, dtype=bool)
    if not alive.any():
        return -1
    return int(received_num[alive].min())


def cascading_trim(received_num, alive_stages) -> list:
    """Fold a cascade of suspicion waves into one cut (DESIGN.md Sec. 7).

    ``alive_stages`` is the survivor mask after each successive wave;
    each stage must be a subset of the previous one (a stage that gains a
    survivor raises).  Returns the per-stage :func:`ragged_trim` values,
    non-decreasing while survivors remain.
    """
    received_num = np.asarray(received_num)
    trims: list = []
    prev = None
    for alive in alive_stages:
        alive = np.asarray(alive, dtype=bool)
        if prev is not None and bool((alive & ~prev).any()):
            raise ValueError(
                "cascade stages must only shrink the survivor set "
                "(suspicions are monotone within a view)")
        trims.append(ragged_trim(received_num, alive))
        if (prev is not None and trims[-1] >= 0
                and trims[-1] < trims[-2]):  # pragma: no cover - by construction
            raise AssertionError("cascading trim rolled a watermark back")
        prev = alive
    return trims
