"""Phase 2 of the two-phase DES: replay the event graph vectorized.

DESIGN.md Sec. 12: phase 1 (:mod:`repro_torch.core.desgraph`) assigns
every event a timestamp and emits a compact
:class:`~repro_torch.core.desgraph.DesGraph`; this module turns that graph
back into the user-facing results —

* :func:`replay` reconstructs per-message latency samples from the
  recorded delivery events (same member-0 sampling point, same float
  subtraction, same ordering as the legacy loop) and assembles the
  :class:`repro_torch.core.simulator.SimResult` bit-identically to
  ``Simulator.run()``;
* the ``*_np`` functions are a numpy mirror of the round-level
  :mod:`repro_torch.core.sweep` arithmetic.  Every operation is int32
  integer math, so a streamed des round is bit-identical to the torch
  ``stream_stacked`` round by construction — that is what makes cut
  epochs (wedge watermarks, ragged trim,
  :class:`~repro_torch.core.group.EpochCarry`) bit-comparable across
  des/graph/kernel instead of merely order-invariant:
  :class:`repro_torch.core.group.GroupStream` drives this mirror through
  the exact same host-side trim/carry/log machinery the device backends
  use.  A :class:`~repro_torch.core.sweep.SweepState` here holds numpy
  leaves; nothing in this module touches a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.core import nullsend, simulator as sim, sst
from repro_torch.core import sweep as sweep_mod

__all__ = ["replay", "sweep_np", "step_backlog_np", "stream_stacked_np",
           "stream_program_np", "batch_states_np"]

_FIELDS = dataclasses.fields(sweep_mod.SweepState)


# ---------------------------------------------------------------------------
# Scheduled-run replay: DesGraph -> SimResult
# ---------------------------------------------------------------------------


def replay(graph) -> sim.SimResult:
    """Replay a :class:`~repro_torch.core.desgraph.DesGraph` into the
    :class:`~repro_torch.core.simulator.SimResult` the legacy single-phase
    ``Simulator.run()`` would have produced — bit-identical, including
    the float latency/throughput fields (DESIGN.md Sec. 12).

    Latencies re-derive from the recorded delivery events at member
    position 0 (the DES's sampling point): the generation-time log is
    append-only, so slicing it at replay time reads the same values the
    legacy loop read at event time.
    """
    cfg = graph.cfg
    groups = graph.groups
    lats: List[float] = []
    at_zero = np.nonzero(graph.deliv_member == 0)[0]
    for i in at_zero.tolist():
        g = groups[int(graph.deliv_gid[i])]
        lo = int(graph.deliv_lo[i])
        hi = int(graph.deliv_hi[i])
        t = float(graph.deliv_time[i])
        for s in range(g.n_s):
            k0 = max(0, math.ceil((lo - s) / g.n_s))
            k1 = (hi - s) // g.n_s
            if k1 < k0:
                continue
            seg = g.gen_log[s][k0:k1 + 1]
            app_mask = ~np.isnan(seg)
            if app_mask.any():
                lats.extend((t - seg[app_mask]).tolist())

    per_node = []
    dur_all = 0.0
    delivered = 0
    for g in groups:
        delivered += int(g.delivered_app.sum())
    for node in range(cfg.n_nodes):
        b = 0.0
        end = 0.0
        for g in graph.node_groups[node]:
            me = g.member_pos[node]
            b += float(g.delivered_app[me]) * g.spec.msg_size
            end = max(end, float(g.last_delivery_time[me]))
        start = graph.first_gen if math.isfinite(graph.first_gen) else 0.0
        if end > start and b > 0:
            per_node.append(b / (end - start) / 1e3)
            dur_all = max(dur_all, end - start)
    lat = np.array(lats) if lats else np.array([0.0])
    return sim.SimResult(
        throughput_GBps=float(np.mean(per_node)) if per_node else 0.0,
        mean_latency_us=float(lat.mean()),
        p99_latency_us=float(np.percentile(lat, 99)),
        duration_us=dur_all,
        delivered_app_msgs=delivered,
        nulls_sent=graph.nulls_sent,
        rdma_writes=graph.rdma_writes,
        post_time_us=float(graph.post_time.sum()),
        predicate_time_us=float(graph.pred_time.sum()),
        send_batches=graph.send_batches,
        recv_batches=graph.recv_batches,
        deliv_batches=graph.deliv_batches,
        sweeps=graph.sweeps,
        sender_blocked_us=float(graph.sender_blocked.sum()),
        per_node_throughput=per_node,
        stalled=graph.stalled,
    )


# ---------------------------------------------------------------------------
# Numpy mirror of the round-level sweep (the des stream substrate)
# ---------------------------------------------------------------------------
#
# Same formulas as repro_torch.core.sweep.sweep / step_backlog /
# stream_stacked, evaluated host-side in numpy int32.  Integer arithmetic
# has no rounding, so these are bit-identical to the torch rounds on the
# same inputs —
# asserted by the conformance suite, relied on by the bit-comparable cut
# semantics of DESIGN.md Sec. 12.


def sweep_np(state: sweep_mod.SweepState, app_ready, *, window=1 << 30,
             null_send=True, member_mask=None, sender_mask=None
             ) -> Tuple[sweep_mod.SweepState, np.ndarray]:
    """Numpy form of :func:`repro_torch.core.sweep.sweep` (one fused
    round)."""
    n_members = state.recv_counts.shape[0]
    n_senders = state.published.shape[0]
    ranks = np.arange(n_senders)
    masked = member_mask is not None or sender_mask is not None
    if masked:
        member_mask = (np.ones(n_members, bool) if member_mask is None
                       else np.asarray(member_mask))
        sender_mask = (np.ones(n_senders, bool) if sender_mask is None
                       else np.asarray(sender_mask))
        s_eff = int(sender_mask.sum())
        big = np.iinfo(np.int32).max

        def prefix(counts):
            return sst.rr_prefix_masked(counts, sender_mask, s_eff)
    else:
        prefix = sst.rr_prefix

    # --- receive predicate ---
    recv_counts = np.maximum(state.recv_counts, state.pub_vis)
    received_num = (np.asarray(prefix(recv_counts)) - 1).astype(np.int32)
    received_num = np.maximum(received_num, state.received_num)

    # --- null predicate ---
    if not null_send:
        nulls = np.zeros_like(state.published)
    else:
        sender_rows = recv_counts[:n_senders]
        have = sender_rows > 0
        if masked:
            have = have & sender_mask[None, :]
        tgt = nullsend.null_target(
            ranks[:, None], sender_rows - 1, ranks[None, :])
        tgt = np.where(have, tgt, 0)
        tgt = np.where(ranks[None, :] == ranks[:, None], 0, tgt)
        target = np.max(tgt, axis=-1)
        next_idx = state.published + app_ready
        nulls = np.maximum(target - next_idx, 0)
        nulls = np.where(app_ready > 0, 0, nulls)
        if masked:
            nulls = np.where(sender_mask, nulls, 0)

    # --- send predicate, ring-window capped ---
    diag = np.arange(n_members)
    deliv_vis_now = state.deliv_vis.copy()
    deliv_vis_now[diag, diag] = state.delivered_num
    if masked:
        deliv_vis_now = np.where(member_mask[None, :], deliv_vis_now, big)
    min_seq = deliv_vis_now.min(axis=1)[:n_senders]
    if masked:
        deliv_counts = sst.sender_counts_masked(min_seq + 1, s_eff,
                                                n_senders)
    else:
        deliv_counts = sst.sender_counts(min_seq + 1, n_senders)
    own_deliv = deliv_counts[ranks, ranks]
    cap = own_deliv + window
    sendable = np.clip(cap - state.published, 0, None)
    app_pub = np.minimum(app_ready, sendable)
    if masked:
        app_pub = np.where(sender_mask, app_pub, 0)
    published = state.published + app_pub + nulls

    # own publishes are received locally immediately
    own = np.zeros_like(recv_counts)
    own[ranks, ranks] = published
    recv_counts = np.maximum(recv_counts, own)
    received_num = np.maximum(
        received_num, (np.asarray(prefix(recv_counts)) - 1).astype(np.int32))

    # --- delivery predicate ---
    recv_vis = state.recv_vis.copy()
    recv_vis[diag, diag] = received_num
    recv_vis_eff = np.where(member_mask[None, :], recv_vis, big) \
        if masked else recv_vis
    stable = recv_vis_eff.min(axis=1)
    delivered_num = np.maximum(state.delivered_num, stable)
    batch = delivered_num - state.delivered_num

    def i32(x):
        return np.asarray(x, np.int32)

    new = sweep_mod.SweepState(
        published=i32(published),
        pub_vis=i32(np.maximum(state.pub_vis, published[None, :])),
        recv_counts=i32(recv_counts),
        received_num=i32(received_num),
        recv_vis=i32(np.maximum(recv_vis, received_num[None, :])),
        delivered_num=i32(delivered_num),
        deliv_vis=i32(np.maximum(state.deliv_vis,
                                 delivered_num[None, :])),
        app_sent=i32(state.app_sent + app_pub),
        nulls_sent=i32(state.nulls_sent + nulls),
    )
    return new, i32(batch)


def step_backlog_np(state, backlog, ready, *, window=1 << 30,
                    null_send=True, member_mask=None, sender_mask=None):
    """Numpy form of :func:`repro_torch.core.sweep.step_backlog` — the
    round body the des :class:`~repro_torch.core.group.GroupStream`
    steps."""
    want = backlog + ready
    new, batch = sweep_np(state, want, window=window, null_send=null_send,
                          member_mask=member_mask, sender_mask=sender_mask)
    pub = new.app_sent - state.app_sent
    return (new, np.asarray(want - pub, np.int32)), \
        (batch, pub, new.nulls_sent - state.nulls_sent)


def stream_stacked_np(states, backlogs, ready, *, windows, null_send,
                      member_masks=None, sender_masks=None):
    """Numpy form of :func:`repro_torch.core.sweep.stream_stacked`: one
    round of all G stacked subgroups, looped host-side per subgroup."""
    g = states.recv_counts.shape[0]
    windows = np.asarray(windows)
    backlogs = np.asarray(backlogs)
    ready = np.asarray(ready)
    new_states, new_backlogs = [], []
    batches, pubs, nulls_out = [], [], []
    for i in range(g):
        st = sweep_mod.SweepState(**{
            f.name: np.asarray(getattr(states, f.name))[i]
            for f in _FIELDS})
        mm = None if member_masks is None else np.asarray(member_masks)[i]
        sm = None if sender_masks is None else np.asarray(sender_masks)[i]
        (nst, nbk), (batch, pub, nl) = step_backlog_np(
            st, backlogs[i], ready[i], window=int(windows[i]),
            null_send=null_send, member_mask=mm, sender_mask=sm)
        new_states.append(nst)
        new_backlogs.append(nbk)
        batches.append(batch)
        pubs.append(pub)
        nulls_out.append(nl)
    states_out = sweep_mod.SweepState(**{
        f.name: np.stack([getattr(x, f.name) for x in new_states])
        for f in _FIELDS})
    return ((states_out, np.stack(new_backlogs)),
            (np.stack(batches), np.stack(pubs), np.stack(nulls_out)))


def stream_program_np(windows, null_send: bool):
    """The des stream's round program, ``fn(states, backlogs, ready,
    *masks)`` with ``masks`` empty or ``(member_masks, sender_masks)``,
    evaluated host-side in numpy: the counterpart of
    :func:`repro_torch.core.sweep.stream_stacked` with bit-identical
    outputs on the same inputs, so
    :class:`~repro_torch.core.group.GroupStream` drives it through the
    same trim/carry/log machinery."""
    win = np.asarray(windows, np.int32)

    def fn(states, backlogs, ready, *masks):
        mm, sm = masks if masks else (None, None)
        return stream_stacked_np(states, backlogs, ready, windows=win,
                                 null_send=null_send,
                                 member_masks=mm, sender_masks=sm)

    return fn


def batch_states_np(n_members: int, n_senders: int,
                    batch: int) -> sweep_mod.SweepState:
    """Numpy form of :func:`repro_torch.core.sweep.batch_states`: a fresh
    stacked state with (G,)-leading int32 numpy leaves."""
    g = batch
    return sweep_mod.SweepState(
        published=np.zeros((g, n_senders), np.int32),
        pub_vis=np.zeros((g, n_members, n_senders), np.int32),
        recv_counts=np.zeros((g, n_members, n_senders), np.int32),
        received_num=np.full((g, n_members), -1, np.int32),
        recv_vis=np.full((g, n_members, n_members), -1, np.int32),
        delivered_num=np.full((g, n_members), -1, np.int32),
        deliv_vis=np.full((g, n_members, n_members), -1, np.int32),
        app_sent=np.zeros((g, n_senders), np.int32),
        nulls_sent=np.zeros((g, n_senders), np.int32),
    )
