"""Deterministic discrete-event simulator of the Derecho/Spindle protocol.

This reproduces the paper's evaluation on the host: N logical nodes run
the atomic-multicast protocol (SST + SMC + predicate sweeps) against the
calibrated RDMA cost model from :mod:`repro_torch.core.costmodel`.  Every
Spindle optimization is a toggle, so the baseline and each incremental
stage (Fig. 5) are simulated like-for-like:

  * ``batch_receive`` / ``batch_delivery`` / ``batch_send`` — opportunistic
    batching per stage (Sec. 3.2).  Off = one event per predicate
    evaluation + an ack per event, as in baseline Derecho.
  * ``null_send`` — the null-send scheme (Sec. 3.3).
  * ``early_lock_release`` — restructured predicates: all RDMA posts happen
    after the lock is released, so the application thread prepares new
    messages concurrently with posting (Sec. 3.4).
  * ``batched_upcall`` / ``memcpy_delivery`` / ``memcpy_send`` — receiver
    delay mitigation (Secs. 3.5, 4.4).

The simulator is a sequential DES over per-node predicate-thread clocks:
the earliest node runs one *sweep* (evaluate all predicates over a snapshot
of its local SST copy), costs are charged per the cost model, and pushes
become timestamped wire writes applied at the destination with monotone
max-merge.  Per-pair FIFO ordering models RDMA's ordering guarantee.

It is host code (numpy, ``heapq``, ``itertools``): it launches no kernel
and touches no device.  Its times are the cost model's modelled times of
the paper's 100 Gb/s testbed, not measurements.  The scenario
configuration types (:class:`SubgroupSpec`, :class:`SenderPattern`,
:class:`SpindleFlags`) are shared by every backend of
:mod:`repro_torch.core.group`; :class:`Simulator` is the ``des-loop``
backend and the base of the two-phase ``des`` backend's phase 1
(:mod:`repro_torch.core.desgraph`).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel, nullsend, smc, sst

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubgroupSpec:
    members: Tuple[int, ...]          # node ids
    senders: Tuple[int, ...]          # subset of members, in rank order
    msg_size: int = 10240
    window: int = 100
    n_messages: int = 1000            # per sender (app messages)

    def __post_init__(self):
        assert set(self.senders) <= set(self.members)


@dataclasses.dataclass(frozen=True)
class SenderPattern:
    """Application sending behaviour for one (subgroup, sender)."""

    inter_send_delay_us: float = 0.0  # busy-wait after each send
    active: bool = True               # False => never sends (nulls cover it)
    # Per-sender app-message budget; None = the SubgroupSpec's n_messages.
    # The Group API lowers explicit per-sender send() counts through this.
    n_messages: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SpindleFlags:
    batch_receive: bool = True
    batch_delivery: bool = True
    batch_send: bool = True
    null_send: bool = True
    early_lock_release: bool = True
    batched_upcall: bool = True
    memcpy_delivery: bool = False
    memcpy_send: bool = False
    # DDS QoS knobs (Sec. 4.6): unordered skips the cross-node stability
    # wait (deliver in local receive order); disk_append models the
    # logged-storage QoS (SSD append in the delivery path).
    wait_stability: bool = True
    disk_append: bool = False

    @classmethod
    def baseline(cls) -> "SpindleFlags":
        return cls(batch_receive=False, batch_delivery=False,
                   batch_send=False, null_send=False,
                   early_lock_release=False, batched_upcall=False)

    @classmethod
    def spindle(cls) -> "SpindleFlags":
        return cls()


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_nodes: int
    subgroups: Tuple[SubgroupSpec, ...]
    flags: SpindleFlags = SpindleFlags.spindle()
    net: costmodel.NetworkModel = costmodel.RDMA_CX6
    host: costmodel.HostModel = costmodel.HOST_X86
    llc_bytes: int = 20 * 1024 * 1024
    upcall_extra_us: float = 0.0      # Sec. 3.5 delay-injection experiment
    max_time_us: float = 60e6
    max_sweeps: int = 3_000_000
    idle_tick_us: float = 2.0
    # Paper Sec. 4.2.1: "We measure bandwidth after a fixed number of
    # messages have been delivered."  When set, the run ends once every
    # member has delivered this many app messages (delayed/inactive senders
    # then do not drag the measurement window out).
    target_delivered: Optional[int] = None
    # patterns[(g, sender_node)] overrides the default continuous pattern
    patterns: Tuple[Tuple[Tuple[int, int], SenderPattern], ...] = ()

    def pattern(self, g: int, node: int) -> SenderPattern:
        for (pg, pn), pat in self.patterns:
            if pg == g and pn == node:
                return pat
        return SenderPattern()


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    throughput_GBps: float            # delivered app bytes/node/us -> GB/s
    mean_latency_us: float
    p99_latency_us: float
    duration_us: float
    delivered_app_msgs: int
    nulls_sent: int
    rdma_writes: int
    post_time_us: float               # predicate-thread time posting writes
    predicate_time_us: float          # total predicate-thread busy time
    send_batches: List[int]
    recv_batches: List[int]
    deliv_batches: List[int]
    sweeps: int
    sender_blocked_us: float          # app-thread time waiting for a slot
    per_node_throughput: List[float]
    stalled: bool                     # ended without delivering everything

    def summary(self) -> Dict[str, float]:
        return {
            "throughput_GBps": round(self.throughput_GBps, 4),
            "mean_latency_us": round(self.mean_latency_us, 3),
            "p99_latency_us": round(self.p99_latency_us, 3),
            "nulls_sent": self.nulls_sent,
            "rdma_writes": self.rdma_writes,
            "post_time_us": round(self.post_time_us, 1),
            "mean_send_batch": round(float(np.mean(self.send_batches)), 2) if self.send_batches else 0.0,
            "mean_recv_batch": round(float(np.mean(self.recv_batches)), 2) if self.recv_batches else 0.0,
            "mean_deliv_batch": round(float(np.mean(self.deliv_batches)), 2) if self.deliv_batches else 0.0,
            "stalled": self.stalled,
        }


# ---------------------------------------------------------------------------
# Per-subgroup runtime state
# ---------------------------------------------------------------------------


class _Group:
    """Mutable protocol state for one subgroup."""

    def __init__(self, gid: int, spec: SubgroupSpec, cfg: SimConfig):
        self.gid = gid
        self.spec = spec
        n_m, n_s = len(spec.members), len(spec.senders)
        self.n_m, self.n_s = n_m, n_s
        self.member_pos = {n: i for i, n in enumerate(spec.members)}
        self.sender_rank = {n: i for i, n in enumerate(spec.senders)}
        # viewer-indexed local SST copies (viewer = member position)
        self.pub_seen = np.zeros((n_m, n_s), dtype=np.int64)      # counts
        self.recv_counts = np.zeros((n_m, n_s), dtype=np.int64)   # processed
        self.recv_seen = np.full((n_m, n_m), -1, dtype=np.int64)  # seq
        self.deliv_seen = np.full((n_m, n_m), -1, dtype=np.int64)
        # authoritative own state per sender
        self.published = np.zeros(n_s, dtype=np.int64)            # counts
        self.queued: List[deque] = [deque() for _ in range(n_s)]  # gen times
        self.generated = np.zeros(n_s, dtype=np.int64)
        self.next_ready = np.zeros(n_s, dtype=np.float64)
        # delivery-side
        self.delivered_app = np.zeros(n_m, dtype=np.int64)
        self.last_delivery_time = np.zeros(n_m, dtype=np.float64)
        # publish-order log per sender; NaN == null message
        self.gen_log: List[np.ndarray] = [
            np.full(256, np.nan) for _ in range(n_s)]
        self.gen_len = np.zeros(n_s, dtype=np.int64)
        self.active = np.array([cfg.pattern(gid, n).active
                                for n in spec.senders], dtype=bool)
        # per-sender app budget: pattern override, else the spec default
        self.msgs = np.array([
            (cfg.pattern(gid, n).n_messages
             if cfg.pattern(gid, n).n_messages is not None
             else spec.n_messages)
            for n in spec.senders], dtype=np.int64)
        self.total_app = int((self.msgs * self.active).sum())
        self.smc = smc.SMCConfig(window=spec.window,
                                 max_msg_size=spec.msg_size)

    def log_append(self, s: int, values: np.ndarray):
        need = int(self.gen_len[s]) + len(values)
        log = self.gen_log[s]
        if need > len(log):
            grown = np.full(max(need, 2 * len(log)), np.nan)
            grown[: len(log)] = log
            self.gen_log[s] = grown
            log = grown
        log[int(self.gen_len[s]): need] = values
        self.gen_len[s] = need

    def app_done(self, s: int) -> bool:
        return (not self.active[s]) or self.generated[s] >= self.msgs[s]


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------


class Simulator:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.groups = [
            _Group(g, spec, cfg) for g, spec in enumerate(cfg.subgroups)]
        n = cfg.n_nodes
        # wire state: per (src, dst) FIFO of (arrival_us, apply_fn)
        self.wire: Dict[Tuple[int, int], deque] = {}
        self.inflight = 0
        self.link_free = np.zeros(n, dtype=np.float64)   # egress NIC clock
        self.pair_last = np.zeros((n, n), dtype=np.float64)
        self.app_block_until = np.zeros(n, dtype=np.float64)
        # metrics
        self.rdma_writes = 0
        self.post_time = np.zeros(n)
        self.pred_time = np.zeros(n)
        self.nulls_sent = 0
        self.send_batches: List[int] = []
        self.recv_batches: List[int] = []
        self.deliv_batches: List[int] = []
        self.latencies: List[float] = []
        self.sender_blocked = np.zeros(n)
        self.lock_busy = np.zeros(n)    # time the SST lock was held
        self.first_gen = math.inf
        self.sweeps = 0
        self.idle_streak = 0
        # SMC polling area -> cache behaviour (Sec. 4.1.2 decline at large w)
        area = sum(g.smc.region_bytes(g.n_m) for g in self.groups)
        self.poll_mult = 6.0 if area > cfg.llc_bytes else 1.0
        # groups a node participates in / sends in
        self.node_groups: List[List[_Group]] = [[] for _ in range(n)]
        for g in self.groups:
            for m in g.spec.members:
                self.node_groups[m].append(g)

    # -- wire ----------------------------------------------------------------

    def _post(self, src: int, t_post: float, dsts: Sequence[int],
              size: int, make_apply) -> float:
        """Post one write of `size` bytes to each dst. Returns the time the
        predicate thread finishes posting. make_apply: dst -> callable."""
        net = self.cfg.net
        t = t_post
        for dst in dsts:
            t += net.post_us
            self.rdma_writes += 1
            self.post_time[src] += net.post_us
            # serialization on the egress link, then (small-size) wire latency
            self.link_free[src] = max(self.link_free[src], t) + \
                net.serialization(size)
            arrival = self.link_free[src] + \
                net.wire_latency(min(size, 4096))
            arrival = max(arrival, self.pair_last[src, dst])  # FIFO per pair
            self.pair_last[src, dst] = arrival
            self.wire.setdefault((src, dst), deque()).append(
                (arrival, make_apply(dst)))
            self.inflight += 1
        return t

    def _drain(self, node: int, now: float):
        for src in range(self.cfg.n_nodes):
            q = self.wire.get((src, node))
            if not q:
                continue
            while q and q[0][0] <= now:
                _, fn = q.popleft()
                fn()
                self.inflight -= 1

    def _next_arrival(self, node: int) -> float:
        best = math.inf
        for src in range(self.cfg.n_nodes):
            q = self.wire.get((src, node))
            if q:
                best = min(best, q[0][0])
        return best

    # -- application thread ---------------------------------------------------

    def _cap(self, g: _Group, me: int, s: int) -> int:
        """Ring-reuse cap: highest publishable count for sender rank s."""
        deliv_counts = sst.sender_counts(g.deliv_seen[me] + 1, g.n_s)[:, s]
        return smc.publish_cap(int(deliv_counts.min()), g.spec.window)

    def _generate(self, g: _Group, node: int, now: float):
        """Advance the app thread of `node` (a sender in g) to `now`: queue
        every message whose ready-time has passed and that has a free slot."""
        s = g.sender_rank[node]
        if not g.active[s]:
            return
        me = g.member_pos[node]
        cap = self._cap(g, me, s)
        gen_floor = self.app_block_until[node]
        while (g.generated[s] < g.msgs[s]
               and int(g.published[s]) + len(g.queued[s]) < cap):
            ready = max(float(g.next_ready[s]), gen_floor)
            if ready > now:
                break
            if self.first_gen > ready:
                self.first_gen = ready
            g.queued[s].append(ready)
            g.generated[s] += 1
            delay = self.cfg.pattern(g.gid, node).inter_send_delay_us
            # in-place construction = writing msg_size bytes into the slot
            # plus slot-acquire/send-call overhead; with memcpy_send the
            # payload is additionally staged from an external buffer (4.4)
            construct = self.cfg.host.memcpy(g.spec.msg_size) + \
                self.cfg.host.app_send_api_us
            if self.cfg.flags.memcpy_send:
                construct += self.cfg.host.memcpy(g.spec.msg_size)
            # Sec. 3.4: message preparation shares the SST lock with the
            # predicate thread.  With a fair mutex the app gets the lock
            # between predicate critical sections, so its effective share
            # of wall time is (1 - lock_frac), where lock_frac is capped
            # by fairness (~55%).  Restructured predicates (early release)
            # exclude RDMA-post time from the critical section, shrinking
            # lock_frac — that is the Sec. 3.4 speedup mechanism.
            if now > 1.0:
                lock_frac = min(self.lock_busy[node] / now, 0.55)
                construct /= (1.0 - lock_frac)
            g.next_ready[s] = ready + max(delay + construct, 1e-3)

    # -- one predicate sweep ---------------------------------------------------

    def _sweep(self, node: int, now: float) -> Tuple[float, bool]:
        """Run one full predicate sweep for `node` starting at `now`.
        Returns (duration_us, did_work)."""
        cfg, host, flags = self.cfg, self.cfg.host, self.cfg.flags
        t = now
        did_work = False
        posts: List[Tuple[Sequence[int], int, object]] = []  # deferred

        def emit(dsts, size, make_apply, t_now):
            """Queue or post a write, honoring the lock-restructuring flag."""
            if flags.early_lock_release:
                # cost is charged when the deferred posts run (after unlock)
                posts.append((dsts, size, make_apply))
                return t_now
            return self._post(node, t_now, dsts, size, make_apply)

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
                        others = [m for m in g.spec.members if m != node]
                        if others:
                            # the SST row push carries the coalesced counter;
                            # baseline acks more often because its sweeps
                            # consume at most one message per sender
                            t = emit(others, 64,
                                     self._mk_recv(g, me, new_recv), t)

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
                    others = [m for m in g.spec.members if m != node]
                    # "sends the determined number of nulls as a single
                    # integer" — one small write per member
                    t = emit(others, 64,
                             self._mk_pub(g, s, int(g.published[s])), t)

            # ---- delivery predicate ----
            if flags.wait_stability:
                stable = int(np.min(g.recv_seen[me]))
            else:  # unordered QoS: deliver in local receive order
                stable = int(g.recv_seen[me, me])
            lo = int(g.deliv_seen[me, me]) + 1
            if stable >= lo:
                n_deliv = (stable - lo + 1) if flags.batch_delivery else 1
                hi = lo + n_deliv - 1
                did_work = True
                self.deliv_batches.append(n_deliv)
                # resolve app vs null + latency, vectorized per sender
                n_app = 0
                for s in range(g.n_s):
                    k0 = max(0, math.ceil((lo - s) / g.n_s))
                    k1 = (hi - s) // g.n_s
                    if k1 < k0:
                        continue
                    seg = g.gen_log[s][k0:k1 + 1]
                    app_mask = ~np.isnan(seg)
                    cnt = int(app_mask.sum())
                    n_app += cnt
                    if cnt and me == 0:   # latency sampled at one receiver
                        self.latencies.extend((t - seg[app_mask]).tolist())
                g.delivered_app[me] += n_app
                if flags.batched_upcall:
                    t += host.upcall_batch_us + n_app * (
                        0.25 * host.upcall_us + cfg.upcall_extra_us)
                else:
                    t += n_app * (host.upcall_us + cfg.upcall_extra_us)
                if flags.memcpy_delivery:
                    t += n_app * host.memcpy(g.spec.msg_size)
                if flags.disk_append:   # logged-storage QoS: SSD append
                    t += n_app * (1.0 + g.spec.msg_size / (2.5 * 1e3))
                g.deliv_seen[me, me] = hi
                g.last_delivery_time[me] = t
                others = [m for m in g.spec.members if m != node]
                if others:
                    t = emit(others, 64, self._mk_deliv(g, me, hi), t)

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
                        wraps = 2 if start_slot + n_send > g.spec.window else 1
                        g.published[s] += n_send
                        g.pub_seen[me, s] = g.published[s]
                        others = [m for m in g.spec.members if m != node]
                        pub = int(g.published[s])
                        if flags.batch_send:
                            # 1 write per member (2 on ring wraparound);
                            # whole slots pushed incl. leftover space
                            sizes = [(n_send - n_send // 2), n_send // 2] \
                                if wraps == 2 else [n_send]
                            for nw in sizes:
                                if nw:
                                    t = emit(others, nw * g.smc.slot_bytes,
                                             self._mk_pub(g, s, pub), t)
                        else:
                            for _ in range(n_send):
                                t = emit(others, g.smc.slot_bytes,
                                         self._mk_pub(g, s, pub), t)
                # app-thread slot-wait accounting
                if (not g.app_done(s) and not g.queued[s]
                        and g.next_ready[s] <= t):
                    self.sender_blocked[node] += max(t - now, 0.0)

        # ---- deferred posts: lock released first (Sec. 3.4) ----
        if flags.early_lock_release:
            self.app_block_until[node] = t   # app proceeds from lock release
            self.lock_busy[node] += t - now  # lock held: logic only
            for dsts, size, make_apply in posts:
                t = self._post(node, t, dsts, size, make_apply)
        else:
            # posts already happened inside the locked region; the app
            # thread could not prepare messages during any of it
            self.app_block_until[node] = t
            self.lock_busy[node] += t - now  # lock held: logic + posts

        self.pred_time[node] += t - now
        return t - now, did_work

    # write constructors — monotone max-merge applications ---------------------

    def _mk_recv(self, g: _Group, src_pos: int, val: int):
        def make(dst: int):
            dpos = g.member_pos[dst]

            def apply():
                g.recv_seen[dpos, src_pos] = max(
                    g.recv_seen[dpos, src_pos], val)
            return apply
        return make

    def _mk_deliv(self, g: _Group, src_pos: int, val: int):
        def make(dst: int):
            dpos = g.member_pos[dst]

            def apply():
                g.deliv_seen[dpos, src_pos] = max(
                    g.deliv_seen[dpos, src_pos], val)
            return apply
        return make

    def _mk_pub(self, g: _Group, sender: int, val: int):
        def make(dst: int):
            dpos = g.member_pos[dst]

            def apply():
                g.pub_seen[dpos, sender] = max(g.pub_seen[dpos, sender], val)
            return apply
        return make

    # -- main loop --------------------------------------------------------------

    def _done(self) -> bool:
        if self.cfg.target_delivered is not None:
            per_member = np.zeros(self.cfg.n_nodes, dtype=np.int64)
            involved = np.zeros(self.cfg.n_nodes, dtype=bool)
            for g in self.groups:
                for node in g.spec.members:
                    per_member[node] += g.delivered_app[g.member_pos[node]]
                    involved[node] = True
            return bool(np.all(per_member[involved]
                               >= self.cfg.target_delivered))
        for g in self.groups:
            if g.total_app and np.any(g.delivered_app < g.total_app):
                return False
        return True

    def run(self) -> SimResult:
        cfg = self.cfg
        # Explicit (time, node, seq) heap key — deterministic tie-break
        # shared with the two-phase event pass (repro_torch.core.desgraph,
        # DESIGN.md Sec. 12): same-timestamp pops order by node id, never
        # by heapq insertion accidents, so permuting subgroup declaration
        # order cannot reorder the event timeline.
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
            self.sweeps += 1
            if did_work:
                self.idle_streak = 0
            else:
                self.idle_streak += 1
            if self._done():
                break
            # stall/quiescence detection: nothing in flight, nobody worked
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
        return self._result()

    def _any_app_pending(self) -> bool:
        for g in self.groups:
            for s in range(g.n_s):
                if g.active[s] and (g.generated[s] < g.msgs[s]
                                    or g.queued[s]):
                    return True
        return False

    def _result(self) -> SimResult:
        per_node = []
        dur_all = 0.0
        delivered = 0
        for g in self.groups:
            delivered += int(g.delivered_app.sum())
        for node in range(self.cfg.n_nodes):
            b = 0.0
            end = 0.0
            for g in self.node_groups[node]:
                me = g.member_pos[node]
                b += float(g.delivered_app[me]) * g.spec.msg_size
                end = max(end, float(g.last_delivery_time[me]))
            start = self.first_gen if math.isfinite(self.first_gen) else 0.0
            if end > start and b > 0:
                per_node.append(b / (end - start) / 1e3)  # bytes/us -> GB/s
                dur_all = max(dur_all, end - start)
        lat = np.array(self.latencies) if self.latencies else np.array([0.0])
        return SimResult(
            throughput_GBps=float(np.mean(per_node)) if per_node else 0.0,
            mean_latency_us=float(lat.mean()),
            p99_latency_us=float(np.percentile(lat, 99)),
            duration_us=dur_all,
            delivered_app_msgs=delivered,
            nulls_sent=self.nulls_sent,
            rdma_writes=self.rdma_writes,
            post_time_us=float(self.post_time.sum()),
            predicate_time_us=float(self.pred_time.sum()),
            send_batches=self.send_batches,
            recv_batches=self.recv_batches,
            deliv_batches=self.deliv_batches,
            sweeps=self.sweeps,
            sender_blocked_us=float(self.sender_blocked.sum()),
            per_node_throughput=per_node,
            stalled=not self._done(),
        )


# ---------------------------------------------------------------------------
# Convenience builders
# ---------------------------------------------------------------------------


def single_subgroup(n_nodes: int, n_senders: Optional[int] = None,
                    msg_size: int = 10240, window: int = 100,
                    n_messages: int = 1000,
                    flags: SpindleFlags = SpindleFlags.spindle(),
                    **kw) -> SimConfig:
    senders = tuple(range(n_senders if n_senders is not None else n_nodes))
    spec = SubgroupSpec(members=tuple(range(n_nodes)), senders=senders,
                        msg_size=msg_size, window=window,
                        n_messages=n_messages)
    return SimConfig(n_nodes=n_nodes, subgroups=(spec,), flags=flags, **kw)


def run(cfg: SimConfig) -> SimResult:
    return Simulator(cfg).run()
