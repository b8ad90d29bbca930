"""Phase 1 of the two-phase DES: timestamp events, emit an event graph.

DESIGN.md Sec. 12: the legacy :class:`repro_torch.core.simulator.Simulator`
charges the full per-predicate Python machinery per event — every wire
write allocates a closure per destination and every drain scans per-pair
deques — which caps cross-backend conformance at toy fleet sizes.  This
module keeps the *identical* event-level timeline (same heap order, same
IEEE-754 cost arithmetic, same SST max-merge semantics) but replaces the
per-destination Python objects with vectorized *wire streams*:

* one :class:`_Stream` per (subgroup, source) carries every SST write
  the node broadcasts as a ``(value, cell, arrival-vector)`` record —
  the n-1 per-destination closures of ``Simulator._post`` become one
  numpy cumsum over the egress-link serialization chain;
* ``head_in[dst, src]`` holds the earliest pending arrival per ordered
  pair, so draining a node is one vectorized due-scan plus one
  ``bisect`` per due stream; each consumed record applies under the
  monotone-max guard, exactly the legacy per-record SST max-merge;
* the heap uses the explicit ``(time, node, seq)`` tie-break key shared
  with the legacy loop, so permuting subgroup declaration order cannot
  reorder same-timestamp events.

The output is a :class:`DesGraph` — per-sweep, per-delivery and
per-publish event arrays plus the final per-subgroup protocol state —
which :mod:`repro_torch.core.desreplay` (phase 2) replays vectorized
into the delivery logs, latencies and
:class:`repro_torch.core.simulator.SimResult` bit-identically to the
legacy single-phase loop.  Host code, like the legacy loop: numpy and
``heapq``, no device.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import nullsend, simulator as sim, sst

__all__ = ["DesGraph", "Phase1", "simulate"]


class _Stream:
    """All SST counter writes from one source node in one subgroup.

    Every counter a node broadcasts (its receive/delivery watermarks,
    its publish count) shares the same destination set, so one merged
    stream per (subgroup, source) carries them all: per record the
    written value plus its destination ``(mat, col)`` cell and the
    ``(ndst,)`` arrival-time vector.  Arrivals per destination are
    nondecreasing (the FIFO ``pair_last`` clamp), so the drain's
    due-scan per destination stops at the first not-yet-due record;
    applying each consumed record under the monotone-max guard is
    exactly the legacy per-record max-merge.
    ``ptr`` is the per-destination count of consumed records; records
    every destination has consumed are pruned in batches, with the
    trigger scaled to the destination count so retained wire state stays
    O(recent) even at 4096 nodes.
    """

    __slots__ = ("g", "p", "dsts", "ptr", "vals", "mats", "cols",
                 "arrs", "base", "nrec", "prune_at")

    def __init__(self, g, p: int, dsts: np.ndarray):
        self.g = g
        self.p = p                      # member position of the source
        self.dsts = dsts
        self.ptr = np.zeros(len(dsts), dtype=np.int64)
        self.vals: List[int] = []
        self.mats: List[np.ndarray] = []
        self.cols: List[int] = []
        self.arrs: List[np.ndarray] = []    # per record: (ndst,) float64
        self.base = 0                   # absolute index of vals[0]
        self.nrec = 0
        self.prune_at = max(8, 16384 // max(len(dsts), 1))


@dataclasses.dataclass
class DesGraph:
    """The compact event/delivery graph phase 1 emits (DESIGN.md Sec. 12).

    Event arrays are in timeline order.  ``groups`` are the final
    :class:`repro_torch.core.simulator._Group` states (gen logs, SST copies,
    delivery watermarks) — phase 2 reads, never mutates, them.
    """

    cfg: sim.SimConfig
    groups: List
    node_groups: List
    # per-sweep events
    sweep_node: np.ndarray       # (E,) int32
    sweep_time: np.ndarray       # (E,) float64 — sweep start
    sweep_dur: np.ndarray        # (E,) float64
    sweep_work: np.ndarray       # (E,) bool
    # per-delivery events (one per delivery-predicate firing)
    deliv_gid: np.ndarray        # (D,) int32
    deliv_member: np.ndarray     # (D,) int32 — member position
    deliv_lo: np.ndarray         # (D,) int64 — first delivered seq
    deliv_hi: np.ndarray         # (D,) int64 — last delivered seq
    deliv_napp: np.ndarray       # (D,) int64 — app messages in [lo, hi]
    deliv_time: np.ndarray       # (D,) float64 — pre-upcall timestamp
    # per-publish events (apps and nulls)
    pub_gid: np.ndarray          # (P,) int32
    pub_rank: np.ndarray         # (P,) int32 — sender rank
    pub_count: np.ndarray        # (P,) int64
    pub_is_null: np.ndarray      # (P,) bool
    pub_time: np.ndarray         # (P,) float64
    # batch-size traces (legacy order)
    send_batches: List[int]
    recv_batches: List[int]
    deliv_batches: List[int]
    # scalar / per-node accounting
    rdma_writes: int
    nulls_sent: int
    sweeps: int
    post_time: np.ndarray
    pred_time: np.ndarray
    sender_blocked: np.ndarray
    lock_busy: np.ndarray
    first_gen: float
    stalled: bool


class Phase1(sim.Simulator):
    """The slimmed event-level pass (DESIGN.md Sec. 12, phase 1).

    Inherits configuration lowering, per-subgroup state, the app thread
    and the cost model from :class:`repro_torch.core.simulator.Simulator`;
    overrides only the wire (`_post`/`_drain`/`_next_arrival`) with the
    vectorized stream machinery and the sweep/run loop with versions
    that record the event graph instead of doing per-event Python work.
    """

    def __init__(self, cfg: sim.SimConfig):
        super().__init__(cfg)
        n = cfg.n_nodes
        # earliest pending arrival per (dst, src); inf = nothing in flight
        self.head_in = np.full((n, n), np.inf)
        self._streams: Dict[Tuple[int, int], _Stream] = {}
        # per node: its (gid, member position) pairs — the drain derives
        # each due pair's stream key and destination slot from these
        # instead of materializing O(N^2) registration entries
        self._node_ginfo: List[List[Tuple[int, int]]] = [
            [(g.gid, g.member_pos[node]) for g in self.node_groups[node]]
            for node in range(n)]
        # event records (lists while building; arrays in the DesGraph)
        self._ev_sweep: List[Tuple[int, float, float, bool]] = []
        self._ev_deliv: List[Tuple[int, int, int, int, int, float]] = []
        self._ev_pub: List[Tuple[int, int, int, bool, float]] = []

    # -- wire streams --------------------------------------------------------

    def _stream_for(self, g, p: int, src: int) -> _Stream:
        key = (g.gid, src)
        st = self._streams.get(key)
        if st is None:
            dsts = np.array([m for m in g.spec.members if m != src],
                            dtype=np.int64)
            st = _Stream(g, p, dsts)
            self._streams[key] = st
        return st

    def _post_record(self, src: int, t0: float, st: _Stream, size: int,
                     val: int, mat: np.ndarray, col: int) -> float:
        """One write of ``size`` bytes to every stream destination —
        ``Simulator._post`` with the per-destination loop replaced by
        cumsum chains over the identical float arithmetic.

        The egress-link recurrence ``L_i = fl(max(L_{i-1}, t_i) + ser)``
        splits into two exactly-vectorizable regimes: with ``ser >=
        post_us`` the link is busy from the second post onward (a pure
        serialization cumsum), otherwise a busy cumsum prefix is
        followed by an idle-forever tail ``fl(t_i + ser)`` — both by
        monotonicity of IEEE rounding, so the chain is bit-identical to
        the sequential loop.
        """
        n = len(st.dsts)
        if n == 0:
            return t0
        net = self.cfg.net
        post_us = net.post_us
        ser = net.serialization(size)
        # predicate-thread post clock: t_i = t0 + i * post_us, sequential
        tc = np.empty(n + 1)
        tc[0] = t0
        tc[1:] = post_us
        np.cumsum(tc, out=tc)
        link0 = self.link_free[src]
        if ser >= post_us:
            L = np.empty(n)
            L[0] = max(link0, tc[1]) + ser
            L[1:] = ser
            np.cumsum(L, out=L)
        else:
            B = np.empty(n + 1)
            B[0] = link0
            B[1:] = ser
            np.cumsum(B, out=B)
            idle = B[:-1] < tc[1:]
            j = int(np.argmax(idle)) if idle.any() else n
            L = np.empty(n)
            L[:j] = B[1:j + 1]
            L[j:] = tc[j + 1:] + ser
        self.link_free[src] = L[-1]
        wl = net.wire_latency(min(size, 4096))
        arr = np.maximum(L + wl, self.pair_last[src, st.dsts])
        self.pair_last[src, st.dsts] = arr
        pc = np.empty(n + 1)
        pc[0] = self.post_time[src]
        pc[1:] = post_us
        self.post_time[src] = np.cumsum(pc)[-1]
        self.rdma_writes += n
        self.inflight += n
        st.vals.append(val)
        st.mats.append(mat)
        st.cols.append(col)
        st.arrs.append(arr)
        st.nrec += 1
        if st.nrec - st.base >= st.prune_at:
            mn = int(st.ptr.min())
            if mn > st.base:
                cut = mn - st.base
                del st.vals[:cut]
                del st.mats[:cut]
                del st.cols[:cut]
                del st.arrs[:cut]
                st.base = mn
        self.head_in[st.dsts, src] = np.minimum(
            self.head_in[st.dsts, src], arr)
        return tc[-1]

    def _drain(self, node: int, now: float):
        """Apply every due write for ``node``: a vectorized due-scan over
        ``head_in``, a first-not-due scan per due stream, and a
        monotone-max apply per consumed record."""
        row = self.head_in[node]
        due = np.nonzero(row <= now)[0]
        if not len(due):
            return
        streams = self._streams
        ginfo = self._node_ginfo[node]
        consumed = 0
        for src in due.tolist():
            best = math.inf
            for gid, q in ginfo:
                st = streams.get((gid, src))
                if st is None:
                    continue
                base, nrec = st.base, st.nrec
                j = q - 1 if q > st.p else q
                k = k0 = int(st.ptr[j])
                arrs = st.arrs
                while k < nrec and arrs[k - base][j] <= now:
                    k += 1
                if k > k0:
                    consumed += k - k0
                    mats, cols, vals = st.mats, st.cols, st.vals
                    for i in range(k0 - base, k - base):
                        m, c, v = mats[i], cols[i], vals[i]
                        if v > m[q, c]:
                            m[q, c] = v
                    st.ptr[j] = k
                if k < nrec:
                    a = arrs[k - base][j]
                    if a < best:
                        best = a
            row[src] = best
        self.inflight -= consumed

    def _next_arrival(self, node: int) -> float:
        return float(self.head_in[node].min())

    # -- one predicate sweep (event-recording form of Simulator._sweep) ------

    def _sweep(self, node: int, now: float) -> Tuple[float, bool]:
        cfg, host, flags = self.cfg, self.cfg.host, self.cfg.flags
        t = now
        did_work = False
        posts: List[Tuple] = []           # deferred posts (Sec. 3.4)

        def emit(st, size, val, mat, col, t_now):
            if flags.early_lock_release:
                posts.append((st, size, val, mat, col))
                return t_now
            return self._post_record(node, t_now, st, size, val, mat,
                                     col)

        for g in self.node_groups[node]:
            me = g.member_pos[node]
            t += host.lock_us + 3 * host.predicate_eval_us

            # ---- receive predicate ----
            if g.n_s:
                counts = g.pub_seen[me]
                fresh = np.maximum(counts - g.recv_counts[me], 0)
                if not flags.batch_receive:
                    fresh = np.minimum(fresh, 1)
                n_new = int(fresh.sum())
                t += host.slot_poll_us * self.poll_mult * (n_new + g.n_s)
                if n_new > 0:
                    did_work = True
                    self.recv_batches.append(n_new)
                    g.recv_counts[me] += fresh
                    new_recv = int(sst.rr_prefix(g.recv_counts[me])) - 1
                    if new_recv > g.recv_seen[me, me]:
                        g.recv_seen[me, me] = new_recv
                        st = self._stream_for(g, me, node)
                        if len(st.dsts):
                            t = emit(st, 64, new_recv, g.recv_seen, me,
                                     t)

            # ---- null-send predicate (Sec. 3.3) ----
            if flags.null_send and node in g.sender_rank and g.n_s > 1:
                s = g.sender_rank[node]
                next_idx = int(g.published[s]) + len(g.queued[s])
                n_nulls = int(nullsend.nulls_needed(
                    s, next_idx, g.recv_counts[me]))
                if n_nulls > 0 and not g.queued[s]:
                    did_work = True
                    self.nulls_sent += n_nulls
                    g.log_append(s, np.full(n_nulls, np.nan))
                    g.published[s] += n_nulls
                    g.pub_seen[me, s] = g.published[s]
                    self._ev_pub.append((g.gid, s, n_nulls, True, t))
                    st = self._stream_for(g, me, node)
                    if len(st.dsts):
                        t = emit(st, 64, int(g.published[s]),
                                 g.pub_seen, s, t)

            # ---- delivery predicate ----
            if flags.wait_stability:
                stable = int(np.min(g.recv_seen[me]))
            else:
                stable = int(g.recv_seen[me, me])
            lo = int(g.deliv_seen[me, me]) + 1
            if stable >= lo:
                n_deliv = (stable - lo + 1) if flags.batch_delivery else 1
                hi = lo + n_deliv - 1
                did_work = True
                self.deliv_batches.append(n_deliv)
                n_app = 0
                for s in range(g.n_s):
                    k0 = max(0, math.ceil((lo - s) / g.n_s))
                    k1 = (hi - s) // g.n_s
                    if k1 < k0:
                        continue
                    seg = g.gen_log[s][k0:k1 + 1]
                    n_app += int((~np.isnan(seg)).sum())
                # latency samples are replayed in phase 2 from this event
                self._ev_deliv.append((g.gid, me, lo, hi, n_app, t))
                g.delivered_app[me] += n_app
                if flags.batched_upcall:
                    t += host.upcall_batch_us + n_app * (
                        0.25 * host.upcall_us + cfg.upcall_extra_us)
                else:
                    t += n_app * (host.upcall_us + cfg.upcall_extra_us)
                if flags.memcpy_delivery:
                    t += n_app * host.memcpy(g.spec.msg_size)
                if flags.disk_append:
                    t += n_app * (1.0 + g.spec.msg_size / (2.5 * 1e3))
                g.deliv_seen[me, me] = hi
                g.last_delivery_time[me] = t
                st = self._stream_for(g, me, node)
                if len(st.dsts):
                    t = emit(st, 64, hi, g.deliv_seen, me, t)

            # ---- send predicate ----
            if node in g.sender_rank:
                s = g.sender_rank[node]
                self._generate(g, node, t)
                if g.queued[s]:
                    cap = self._cap(g, me, s)
                    n_send = int(min(len(g.queued[s]),
                                     cap - int(g.published[s])))
                    if not flags.batch_send:
                        n_send = min(n_send, 1)
                    if n_send > 0:
                        did_work = True
                        self.send_batches.append(n_send)
                        times = np.array([g.queued[s].popleft()
                                          for _ in range(n_send)])
                        g.log_append(s, times)
                        start_slot = int(g.published[s]) % g.spec.window
                        wraps = 2 if start_slot + n_send > g.spec.window \
                            else 1
                        g.published[s] += n_send
                        g.pub_seen[me, s] = g.published[s]
                        pub = int(g.published[s])
                        self._ev_pub.append((g.gid, s, n_send, False, t))
                        st = self._stream_for(g, me, node)
                        if len(st.dsts):
                            if flags.batch_send:
                                sizes = [(n_send - n_send // 2),
                                         n_send // 2] \
                                    if wraps == 2 else [n_send]
                                for nw in sizes:
                                    if nw:
                                        t = emit(st,
                                                 nw * g.smc.slot_bytes,
                                                 pub, g.pub_seen, s, t)
                            else:
                                for _ in range(n_send):
                                    t = emit(st, g.smc.slot_bytes, pub,
                                             g.pub_seen, s, t)
                if (not g.app_done(s) and not g.queued[s]
                        and g.next_ready[s] <= t):
                    self.sender_blocked[node] += max(t - now, 0.0)

        # ---- deferred posts: lock released first (Sec. 3.4) ----
        if flags.early_lock_release:
            self.app_block_until[node] = t
            self.lock_busy[node] += t - now
            for st, size, val, mat, col in posts:
                t = self._post_record(node, t, st, size, val, mat, col)
        else:
            self.app_block_until[node] = t
            self.lock_busy[node] += t - now

        self.pred_time[node] += t - now
        return t - now, did_work

    # -- main loop -----------------------------------------------------------

    def run_graph(self) -> DesGraph:
        """The legacy event loop with the explicit ``(time, node, seq)``
        heap key (DESIGN.md Sec. 12), recording one sweep event per pop."""
        cfg = self.cfg
        seq = itertools.count()
        heap = [(0.0, node, next(seq)) for node in range(cfg.n_nodes)
                if self.node_groups[node]]
        heapq.heapify(heap)
        n_live = len(heap)
        while heap and self.sweeps < cfg.max_sweeps:
            now, node, _ = heapq.heappop(heap)
            if now > cfg.max_time_us:
                break
            self._drain(node, now)
            dur, did_work = self._sweep(node, now)
            self._ev_sweep.append((node, now, dur, did_work))
            self.sweeps += 1
            if did_work:
                self.idle_streak = 0
            else:
                self.idle_streak += 1
            if self._done():
                break
            if (self.idle_streak > 30 * n_live and self.inflight == 0
                    and not self._any_app_pending()):
                break
            if did_work:
                nxt = now + max(dur, 0.05)
            else:
                pend = self._next_arrival(node)
                app = math.inf
                for g in self.node_groups[node]:
                    if node in g.sender_rank and not g.app_done(
                            g.sender_rank[node]):
                        app = min(app, float(
                            g.next_ready[g.sender_rank[node]]))
                nxt = min(pend, app)
                if not math.isfinite(nxt):
                    nxt = now + 50 * cfg.idle_tick_us
                nxt = max(nxt, now + cfg.idle_tick_us)
            heapq.heappush(heap, (nxt, node, next(seq)))
        return self._graph()

    def _graph(self) -> DesGraph:
        ev_s = self._ev_sweep
        ev_d = self._ev_deliv
        ev_p = self._ev_pub
        return DesGraph(
            cfg=self.cfg,
            groups=self.groups,
            node_groups=self.node_groups,
            sweep_node=np.array([e[0] for e in ev_s], np.int32),
            sweep_time=np.array([e[1] for e in ev_s], np.float64),
            sweep_dur=np.array([e[2] for e in ev_s], np.float64),
            sweep_work=np.array([e[3] for e in ev_s], bool),
            deliv_gid=np.array([e[0] for e in ev_d], np.int32),
            deliv_member=np.array([e[1] for e in ev_d], np.int32),
            deliv_lo=np.array([e[2] for e in ev_d], np.int64),
            deliv_hi=np.array([e[3] for e in ev_d], np.int64),
            deliv_napp=np.array([e[4] for e in ev_d], np.int64),
            deliv_time=np.array([e[5] for e in ev_d], np.float64),
            pub_gid=np.array([e[0] for e in ev_p], np.int32),
            pub_rank=np.array([e[1] for e in ev_p], np.int32),
            pub_count=np.array([e[2] for e in ev_p], np.int64),
            pub_is_null=np.array([e[3] for e in ev_p], bool),
            pub_time=np.array([e[4] for e in ev_p], np.float64),
            send_batches=self.send_batches,
            recv_batches=self.recv_batches,
            deliv_batches=self.deliv_batches,
            rdma_writes=self.rdma_writes,
            nulls_sent=self.nulls_sent,
            sweeps=self.sweeps,
            post_time=self.post_time,
            pred_time=self.pred_time,
            sender_blocked=self.sender_blocked,
            lock_busy=self.lock_busy,
            first_gen=self.first_gen,
            stalled=not self._done(),
        )


def simulate(cfg: sim.SimConfig) -> DesGraph:
    """Run phase 1: timestamp the full event timeline and return the
    compact event graph (DESIGN.md Sec. 12)."""
    return Phase1(cfg).run_graph()
