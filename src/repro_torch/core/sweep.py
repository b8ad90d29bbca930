"""The fused predicate sweep as a PyTorch protocol round.

The analogue of Derecho's single predicate thread (Sec. 2.4) is one
function that evaluates every node's send/receive/null/delivery
predicates over SST tensors in one step, with *one-round-delayed*
visibility standing in for wire latency.

Where the reference vmaps a one-subgroup round over subgroups (G) and
grid points (B), every function here takes those as leading tensor
dimensions: a state leaf has shape ``(*lead, ·)``, windows and flags
have shape ``lead`` (or broadcast to it), and validity masks broadcast
against ``(*lead, N)``/``(*lead, S)``.  ``lax.scan`` becomes a Python
loop over rounds that writes each round's traces into preallocated
``(*lead, T, ·)`` int32 tensors; nothing in the loop copies to the host,
so on the GPU a whole run enqueues without one synchronisation.

The receive predicate's consumption step is pluggable via ``receive_fn``
with the 3-arg contract ``(pub_vis, recv_counts, valid) -> new
recv_counts`` (``valid`` = the (…, N, S) padded-lane validity mask, or
None when unpadded); see :func:`sweep` and DESIGN.md Sec. 3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import nullsend, sst

I32 = torch.int32
BIG = torch.iinfo(torch.int32).max
Lead = Union[int, Tuple[int, ...]]


@dataclasses.dataclass
class SweepState:
    """Protocol state for subgroups with S senders and N members, over any
    leading dimensions.

    ``*_vis`` tensors are what each node currently *sees* of the others'
    rows (its local SST copy); authoritative rows are the diagonal / own
    entries.  :func:`sweep` returns the post-round state with a visibility
    that lags by exactly one round.
    """

    published: torch.Tensor      # (..., S)    authoritative per-sender counts
    pub_vis: torch.Tensor        # (..., N, S) node's view of published counts
    recv_counts: torch.Tensor    # (..., N, S) per-node processed counts
    received_num: torch.Tensor   # (..., N)    rr-prefix seq per node
    recv_vis: torch.Tensor       # (..., N, N) view of others' received_num
    delivered_num: torch.Tensor  # (..., N)    per-node delivered seq
    deliv_vis: torch.Tensor      # (..., N, N)
    app_sent: torch.Tensor       # (..., S)    app messages published so far
    nulls_sent: torch.Tensor     # (..., S)

    @classmethod
    def init(cls, n_members: int, n_senders: int, device=None,
             lead: Lead = ()) -> "SweepState":
        """A fresh state, broadcast over leading dims ``lead``."""
        dev = resolve_device(device)
        lead = (lead,) if isinstance(lead, int) else tuple(lead)
        n, s = n_members, n_senders

        def full(shape, value):
            return torch.full(lead + shape, value, dtype=I32, device=dev)

        return cls(published=full((s,), 0), pub_vis=full((n, s), 0),
                   recv_counts=full((n, s), 0), received_num=full((n,), -1),
                   recv_vis=full((n, n), -1), delivered_num=full((n,), -1),
                   deliv_vis=full((n, n), -1), app_sent=full((s,), 0),
                   nulls_sent=full((s,), 0))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Every leaf copied to the host, keyed by field name."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def state_from_numpy(mapping: Mapping[str, np.ndarray],
                     device=None) -> SweepState:
    """A :class:`SweepState` from host arrays keyed by field name (e.g. a
    reference state's leaves, or :meth:`SweepState.to_numpy`), as int32
    on ``device``."""
    dev = resolve_device(device)
    return SweepState(**{
        f.name: torch.as_tensor(np.array(mapping[f.name], np.int32),
                                device=dev)
        for f in dataclasses.fields(SweepState)})


def batch_states(n_members: int, n_senders: int, batch: Lead,
                 device=None) -> SweepState:
    """A fresh SweepState over leading dims ``batch`` (an int B, or a
    tuple such as (B, G)) — the carry layout :func:`run_stacked` and
    :func:`run_stacked_batch` expect."""
    return SweepState.init(n_members, n_senders, device, lead=batch)


def _lead(x):
    """A per-subgroup value (window, flag, s_eff) lifted to broadcast over
    the last axis; Python scalars pass through."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def _set_diag(x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Copy of ``x`` with ``x[..., i, i] = values[..., i]`` (the
    reference's ``.at[diag, diag].set``)."""
    out = x.clone()
    out.diagonal(dim1=-2, dim2=-1).copy_(values)
    return out


def sweep(state: SweepState, app_ready: torch.Tensor, *, window=1 << 30,
          null_send=True, receive_fn=None, member_mask=None,
          sender_mask=None) -> Tuple[SweepState, torch.Tensor]:
    """One fused protocol round for every node simultaneously.

    app_ready: (..., S) int32 — app messages each sender wants to publish
    this round.  Sender rank i is member i (the first S members are the
    senders, matching Derecho's rank ordering).

    ``window`` is an int or an int32 tensor of the leading shape;
    ``null_send`` a Python bool (``False`` drops the null branch) or a
    bool tensor of the leading shape (a disabled point masks its nulls to
    zero, as the reference's traced flag does in ``run_batch`` grids).

    receive_fn: optional ``(pub_vis, recv_counts, valid) -> new
    recv_counts`` override for the receive predicate; the default is the
    ``max`` merge.  member_mask/sender_mask: optional bool validity masks
    broadcastable to (..., N)/(..., S) for padded stacked execution —
    padding must be a SUFFIX.  Masked slots never publish, never receive,
    and never hold back any min-reduction; the round-robin order is over
    the real sender count, so the active sub-array evolves bit-identically
    to an unpadded sweep.

    Returns (new_state, delivered_batch_sizes (..., N)).
    """
    n_senders = state.published.shape[-1]
    masked = member_mask is not None or sender_mask is not None
    if masked:
        if member_mask is None:
            member_mask = torch.ones(state.delivered_num.shape[-1],
                                     dtype=torch.bool,
                                     device=state.published.device)
        if sender_mask is None:
            sender_mask = torch.ones(n_senders, dtype=torch.bool,
                                     device=state.published.device)
        s_eff = sender_mask.sum(dim=-1, dtype=I32)

        def prefix(counts):
            return sst.rr_prefix_masked(counts, sender_mask[..., None, :],
                                        _lead(s_eff))
    else:
        prefix = sst.rr_prefix

    # --- receive predicate (all nodes): consume everything visible -------
    if receive_fn is None:
        recv_counts = torch.maximum(state.recv_counts, state.pub_vis)
    else:
        valid = (member_mask[..., :, None] & sender_mask[..., None, :]) \
            if masked else None
        recv_counts = receive_fn(state.pub_vis, state.recv_counts, valid)
    received_num = torch.maximum((prefix(recv_counts) - 1).to(I32),
                                 state.received_num)

    # --- null predicate (sender nodes) -----------------------------------
    if isinstance(null_send, bool) and not null_send:
        nulls = torch.zeros_like(state.published)
    else:
        ranks = torch.arange(n_senders, device=recv_counts.device)
        sender_rows = recv_counts[..., :n_senders, :]          # (..., S, S)
        have = sender_rows > 0
        if masked:
            have = have & sender_mask[..., None, :]
        tgt = nullsend.null_target(ranks[:, None], sender_rows - 1,
                                   ranks[None, :])
        tgt = torch.where(have, tgt, 0)
        tgt = torch.where(ranks[None, :] == ranks[:, None], 0, tgt)
        target = tgt.amax(dim=-1)                              # (..., S)
        next_idx = state.published + app_ready                 # after sends
        nulls = torch.clamp(target - next_idx, min=0)
        nulls = torch.where(app_ready > 0, 0, nulls)
        if isinstance(null_send, torch.Tensor):
            nulls = torch.where(_lead(null_send), nulls, 0)
        if masked:
            nulls = torch.where(sender_mask, nulls, 0)

    # --- send predicate (sender nodes), ring-window capped ----------------
    deliv_vis_now = _set_diag(state.deliv_vis, state.delivered_num)
    if masked:
        deliv_vis_now = torch.where(member_mask[..., None, :], deliv_vis_now,
                                    BIG)
    min_seq = deliv_vis_now.amin(dim=-1)[..., :n_senders]     # (..., S)
    if masked:
        deliv_counts = sst.sender_counts_masked(min_seq + 1, _lead(s_eff),
                                                n_senders)     # (..., S, S)
    else:
        deliv_counts = sst.sender_counts(min_seq + 1, n_senders)
    own_deliv = deliv_counts.diagonal(dim1=-2, dim2=-1)
    cap = own_deliv + _lead(window)
    sendable = torch.clamp(cap - state.published, min=0)
    app_pub = torch.minimum(app_ready, sendable)
    if masked:
        app_pub = torch.where(sender_mask, app_pub, 0)
    published = state.published + app_pub + nulls

    # own publishes are received locally immediately (sender rank r is
    # member r, so they land on the (r, r) diagonal of recv_counts)
    own = recv_counts.diagonal(dim1=-2, dim2=-1)
    recv_counts = _set_diag(recv_counts, torch.maximum(own, published))
    received_num = torch.maximum(
        received_num, (prefix(recv_counts) - 1).to(I32))

    # --- delivery predicate: min over *visible* received_num --------------
    # own entry is authoritative; other members' entries lag one round
    recv_vis = _set_diag(state.recv_vis, received_num)
    recv_vis_eff = torch.where(member_mask[..., None, :], recv_vis, BIG) \
        if masked else recv_vis
    stable = recv_vis_eff.amin(dim=-1)                         # (..., N)
    delivered_num = torch.maximum(state.delivered_num, stable)
    batch = delivered_num - state.delivered_num

    # --- "wire": visibility catches up to this round's authoritative rows -
    new = SweepState(
        published=published,
        pub_vis=torch.maximum(state.pub_vis, published[..., None, :]),
        recv_counts=recv_counts,
        received_num=received_num,
        recv_vis=torch.maximum(recv_vis, received_num[..., None, :]),
        delivered_num=delivered_num,
        deliv_vis=torch.maximum(state.deliv_vis, delivered_num[..., None, :]),
        app_sent=state.app_sent + app_pub,
        nulls_sent=state.nulls_sent + nulls,
    )
    return new, batch


def run_rounds(state: SweepState, app_schedule: torch.Tensor, *,
               window=1 << 30, null_send: bool = True
               ) -> Tuple[SweepState, torch.Tensor]:
    """Rounds of :func:`sweep` without requeueing.  app_schedule:
    (..., T, S) messages ready per round.  Returns the final state and
    (..., T, N) delivered batch sizes."""
    t_rounds = app_schedule.shape[-2]
    batches = torch.empty(state.delivered_num.shape[:-1]
                          + (t_rounds, state.delivered_num.shape[-1]),
                          dtype=I32, device=app_schedule.device)
    for t in range(t_rounds):
        state, batch = sweep(state, app_schedule[..., t, :], window=window,
                             null_send=null_send)
        batches[..., t, :] = batch
    return state, batches


def step_backlog(state: SweepState, backlog: torch.Tensor,
                 ready: torch.Tensor, *, window=1 << 30, null_send=True,
                 receive_fn=None, member_mask=None, sender_mask=None):
    """One protocol round with the DES app-queue semantics: messages the
    ring window throttles are requeued into ``backlog``, not dropped.

    Returns ``((new_state, new_backlog), (delivered_batch (..., N),
    app_published (..., S), nulls_published (..., S)))``.
    """
    want = backlog + ready
    new, batch = sweep(state, want, window=window, null_send=null_send,
                       receive_fn=receive_fn, member_mask=member_mask,
                       sender_mask=sender_mask)
    pub = new.app_sent - state.app_sent
    return (new, want - pub), (batch, pub, new.nulls_sent - state.nulls_sent)


def scan_rounds(state: SweepState, app_schedule: torch.Tensor, *,
                window=1 << 30, null_send=True, receive_fn=None,
                member_mask=None, sender_mask=None, backlog0=None
                ) -> Tuple[SweepState, Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]]:
    """:func:`step_backlog` over every round of ``app_schedule``
    ((..., T, S) app messages becoming ready per round) with full
    per-round traces.

    ``backlog0`` is the epoch-carry initial backlog (DESIGN.md Sec. 7):
    per-sender resend counts from the previous view's cut, queued ahead of
    round 0.  ``None`` means a fresh epoch (zeros).

    Returns (final_state, (delivered_batches (..., T, N), app_published
    (..., T, S), nulls_published (..., T, S))), all int32 on the
    schedule's device.
    """
    lead = state.published.shape[:-1]
    n_members = state.delivered_num.shape[-1]
    n_senders = state.published.shape[-1]
    t_rounds = app_schedule.shape[-2]
    dev = app_schedule.device
    backlog = torch.zeros(lead + (n_senders,), dtype=I32, device=dev) \
        if backlog0 is None else backlog0.to(I32).expand(
            lead + (n_senders,))
    batches = torch.empty(lead + (t_rounds, n_members), dtype=I32,
                          device=dev)
    app_pub = torch.empty(lead + (t_rounds, n_senders), dtype=I32,
                          device=dev)
    nulls = torch.empty_like(app_pub)
    for t in range(t_rounds):
        (state, backlog), (b, p, nl) = step_backlog(
            state, backlog, app_schedule[..., t, :], window=window,
            null_send=null_send, receive_fn=receive_fn,
            member_mask=member_mask, sender_mask=sender_mask)
        batches[..., t, :] = b
        app_pub[..., t, :] = p
        nulls[..., t, :] = nl
    return state, (batches, app_pub, nulls)


def quiescent_stacked(states: SweepState, backlogs: torch.Tensor,
                      n_members=None, n_senders=None) -> torch.Tensor:
    """Quiescence over a stacked (G-leading) state: no backlog anywhere
    and every PUBLISHED message delivered by every real member
    (delivered >= every sender's last published seq, not merely the rr
    prefix).  ``n_members``/``n_senders`` optionally mask padded lanes
    ((G,) int real counts); ``None`` means the stack is unpadded.
    Returns a 0-d bool tensor (no host copy)."""
    n_max = states.delivered_num.shape[-1]
    s_max = states.published.shape[-1]
    dev = states.published.device
    ranks = torch.arange(s_max, device=dev, dtype=I32)
    pub = states.published                              # (G, S)
    sender_valid = pub > 0
    backlog_ok = backlogs == 0
    if n_senders is not None:
        n_senders = torch.as_tensor(n_senders, dtype=I32, device=dev)
        lane = ranks[None, :] < n_senders[:, None]
        sender_valid = sender_valid & lane
        backlog_ok = backlog_ok | ~lane
        per_round = n_senders[:, None]
    else:
        per_round = s_max
    last_seq = (pub - 1) * per_round + ranks[None, :]
    need = torch.where(sender_valid, last_seq, -1).amax(dim=1)   # (G,)
    deliv = states.delivered_num                        # (G, N)
    if n_members is not None:
        n_members = torch.as_tensor(n_members, dtype=I32, device=dev)
        rows = torch.arange(n_max, device=dev)[None, :] < n_members[:, None]
        deliv = torch.where(rows, deliv, BIG)
    return backlog_ok.all() & (deliv >= need[:, None]).all()


# ---------------------------------------------------------------------------
# Stacked multi-subgroup execution (paper Sec. 2.4, taken across subgroups)
# ---------------------------------------------------------------------------
#
# A whole group — G subgroups padded to a common (N_max, S_max) with
# validity masks — sweeps as ONE stacked round: the subgroup axis is a
# leading tensor dimension.  The subgroups are protocol-independent, so
# each padded lane evolves bit-identically to its own unpadded run.

def run_stacked(states: SweepState, app_schedules: torch.Tensor, *,
                windows: torch.Tensor, null_send, member_masks=None,
                sender_masks=None, receive_fn=None, backlogs0=None):
    """All G subgroups of one scenario in a single stacked loop.

    states: SweepState with leading (G,) leaves (see
    :func:`batch_states`); app_schedules: (G, T, S_max); windows: (G,)
    int32; null_send: one Python bool for the group; member_masks /
    sender_masks: (G, N_max)/(G, S_max) bool, or None for a homogeneous
    stack (which keeps the unmasked arithmetic); backlogs0: (G, S_max)
    int32 epoch-carry backlogs or None.  Returns final states and
    (G, T, ...) traces.
    """
    return scan_rounds(states, app_schedules, window=windows,
                       null_send=null_send, receive_fn=receive_fn,
                       member_mask=member_masks, sender_mask=sender_masks,
                       backlog0=backlogs0)


def stream_stacked(states: SweepState, backlogs: torch.Tensor,
                   ready: torch.Tensor, *, windows: torch.Tensor, null_send,
                   member_masks=None, sender_masks=None, receive_fn=None):
    """ONE round of all G subgroups — the streaming form of
    :func:`run_stacked` (the same :func:`step_backlog`, so T streamed
    rounds are bit-identical to one T-round stacked run fed the same
    ``ready`` rows).  Returns ``((states, backlogs), (batch (G, N_max),
    app_pub (G, S_max), nulls (G, S_max)))``."""
    return step_backlog(states, backlogs, ready, window=windows,
                        null_send=null_send, receive_fn=receive_fn,
                        member_mask=member_masks, sender_mask=sender_masks)


def run_stacked_batch(states: SweepState, app_schedules: torch.Tensor, *,
                      windows: torch.Tensor, null_sends: torch.Tensor,
                      member_masks=None, sender_masks=None, receive_fn=None):
    """B scenario points x G subgroups as one doubly-batched loop.

    states: SweepState with leading (B, G) leaves; app_schedules:
    (B, G, T, S_max); windows: (B, G) int32; null_sends: (B,) bool (each
    point's flag broadcasts over its subgroups); masks: (G, N_max) /
    (G, S_max) shared across points, or None for a homogeneous stack.
    """
    return scan_rounds(states, app_schedules, window=windows,
                       null_send=null_sends[:, None],
                       receive_fn=receive_fn, member_mask=member_masks,
                       sender_mask=sender_masks)
