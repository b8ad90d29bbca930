"""Serve-plane multicast: request fan-out on the stacked group substrate.

The paper's end-to-end payoff is the OMG-DDS built over Derecho inheriting
the batching and null-send optimizations; the analogue here is the serving
plane riding the multicast substrate.  :class:`ReplicatedEngine` runs G
replica :class:`~repro_torch.serve.engine.ServeEngine`\\ s and publishes
every decode round's events — admitted requests and emitted tokens — as
messages on one DDS topic per replica, streamed through the stacked round
that runs benchmark scenarios (:meth:`repro_torch.core.dds.Domain.bind`
-> :class:`repro_torch.core.group.GroupStream`): engine slots x replica
subgroups, one stacked round per engine round.

The slot ring IS the SMC ring:

* **senders = slots.**  Each topic's publishers are the replica's KV
  slots (one multicast sender rank per slot), so the admission order is
  the protocol's round-robin total order.
* **stalled clients = null-send rounds.**  A slot whose client applies
  backpressure decodes a null step and publishes nothing; the null-send
  scheme covers its rank so every other slot's tokens keep delivering.
* **slot free = delivery watermark.**  A completed request's slot may
  admit new work only once the multicast watermark shows its last token
  message delivered at every subscriber.

:meth:`ReplicatedEngine.run` returns the multicast
:class:`~repro_torch.core.group.RunReport` merged with serving metrics
(``extras["serve"]``: tokens/s, decode steps, stall rounds, host hops).
Mid-run failures (``fail_at``) cross the virtual-synchrony cut: in-flight
messages are delivered everywhere at the ragged trim or resent in the
next view, and a dead slot's in-flight decode is voided and re-admitted.
``fused=True`` runs each membership epoch as one device program
(:mod:`repro_torch.serve.fused`) with zero host hops between cuts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import dds
from repro_torch.core import views as views_mod
from repro_torch.core.group import RunReport
from repro_torch.load.admission import ServeAdmission
from repro_torch.serve.engine import Request, ServeEngine

# stall_fn(replica, engine_round) -> slots whose client is backpressured
StallFn = Callable[[int, int], Sequence[int]]

# arrive_fn(replica, engine_round) -> requests arriving open-loop that
# round
ArriveFn = Callable[[int, int], Sequence[Request]]


def _as_waves(spec) -> List[List[int]]:
    """Normalize one ``fail_at`` value: a flat node sequence is a single
    suspicion batch; a sequence of sequences is a CASCADE — later waves
    land while the wedge for the first is in progress and fold into the
    same installed view (DESIGN.md Sec. 7).  Mixing the two shapes in
    one value is ambiguous and raises."""
    spec = list(spec)
    nested = [isinstance(w, (list, tuple, set, frozenset)) for w in spec]
    if all(nested) and spec:
        return [sorted(int(n) for n in w) for w in spec if w]
    if any(nested):
        raise ValueError(
            "fail_at value mixes node ids and waves: use either a flat "
            "sequence of nodes or a sequence of waves")
    return [sorted(int(n) for n in spec)] if spec else []


@dataclasses.dataclass
class _SlotHold:
    """A completed request whose slot awaits the delivery watermark."""

    target_apps: int                 # enqueued app messages at finish time
    last_idx: Optional[int] = None   # publish index of the last app msg
    finished_round: int = 0


class ReplicatedEngine:
    """G replica serve engines whose decode rounds ride one stacked
    multicast stream.

    ``engines`` are the replicas (replica ``g``'s topic gets one sender
    rank per KV slot).  Each replica's topic is subscribed by
    ``subscribers_per_replica`` follower nodes (standbys / response
    loggers — the processes that must observe the replica's
    admission+token stream in total order).  ``stall_fn(g, round)`` names
    the slots of replica ``g`` whose client is backpressured that engine
    round; a boolean ``(rounds, G, slots)`` ndarray is also accepted.
    ``window`` is the per-slot SMC ring window: how many undelivered
    messages a slot may have in flight before the send predicate
    throttles it.  The multicast rounds run on ``device`` (the GPU unless
    ``"cpu"`` is named) on ``backend`` (``"kernel"`` or ``"graph"``).
    """

    def __init__(self, engines: Sequence[ServeEngine], *,
                 subscribers_per_replica: int = 1, window: int = 8,
                 sample_size: int = 2048,
                 qos: dds.QoS = dds.QoS.ATOMIC_MULTICAST,
                 backend: str = "kernel",
                 stall_fn: Optional[StallFn] = None,
                 device: DeviceLike = None):
        if not engines:
            raise ValueError("need at least one replica engine")
        self.engines = list(engines)
        self.backend = backend
        self.stall_fn = stall_fn
        self.device = resolve_device(device)
        self._slots = [eng.ecfg.max_batch for eng in self.engines]
        # Slot nodes are numbered BELOW the replica's subscriber nodes so
        # each topic's publishers are its first members in slot order —
        # sender rank s == slot s (the sweep's rank convention).
        node = 0
        self.domain = dds.Domain(n_nodes=0)
        self.topics: List[dds.Topic] = []
        self._slot_nodes: List[List[int]] = []   # replica -> slot -> node
        self._node_to_slot: Dict[int, Tuple[int, int]] = {}  # node -> (g, s)
        for g, b in enumerate(self._slots):
            slot_nodes = list(range(node, node + b))
            subs = list(range(node + b,
                              node + b + subscribers_per_replica))
            node += b + subscribers_per_replica
            self.domain.n_nodes = node
            self.topics.append(self.domain.create_topic(
                f"replica-{g}", publishers=slot_nodes, subscribers=subs,
                sample_size=sample_size, qos=qos, window=window))
            self._slot_nodes.append(slot_nodes)
            for s, n in enumerate(slot_nodes):
                self._node_to_slot[n] = (g, s)
        self._reset_run_state()
        self.last_report: Optional[RunReport] = None
        # fused round programs (serve/fused.py), built once per epoch
        # shape; they hold the engines' caches, so they live on this
        # object and go with it
        self._fused_programs: Dict[Tuple, Any] = {}

    # -- bookkeeping ---------------------------------------------------------

    def _reset_run_state(self):
        g_n = len(self.engines)
        self._apps_enqueued = [np.zeros(b, np.int64) for b in self._slots]
        self._holds: List[Dict[int, _SlotHold]] = [{} for _ in
                                                   range(g_n)]
        # per-run traces (tests read these)
        self.admit_rounds: Dict[int, int] = {}       # rid -> engine round
        self.admit_slots: Dict[int, Tuple[int, int]] = {}  # rid -> (g, s)
        self.finish_rounds: List[Tuple[int, int, int]] = []  # (g, s, rnd)
        self.free_rounds: List[Tuple[int, int, int]] = []    # (g, s, rnd)
        self.stall_rounds = 0
        # open-loop traces
        self.submit_rounds: Dict[int, int] = {}      # rid -> arrival rnd
        self.finish_round_by_rid: Dict[int, int] = {}
        self.shed_log: List[Tuple[int, int]] = []    # (rid, round shed)
        self.queue_depth_log: List[int] = []         # total queued / rnd
        self.backlog_log: List[int] = []             # stream backlog / rnd
        self._last_view = None
        # mid-run view changes (fail_at): one entry per installed view —
        # (engine round, View, closing-epoch report, {topic: cut log})
        self.view_log: List[Tuple[int, views_mod.View, RunReport,
                                  Dict[str, object]]] = []
        # slot-node failure state: dead engine slots per replica, and the
        # live slot <-> sender-rank maps of the CURRENT view (a cut that
        # removes a slot node compacts the surviving slots, in slot
        # order, onto sender ranks 0..k-1 — dds reconfigure keeps the
        # declaration order, so rank order == slot order)
        self._dead_slots: List[set] = [set() for _ in range(g_n)]
        self._rank_slot: List[List[int]] = [list(range(b))
                                            for b in self._slots]
        self._slot_rank: List[Dict[int, int]] = [
            {s: s for s in range(b)} for b in self._slots]
        self.slot_failures: List[Dict[str, object]] = []
        self.cut_walls: List[float] = []   # per installed view (wall s)
        # failures drive a real membership service so cascading waves
        # fold into ONE installed view (views.propose_and_install)
        self._ms = views_mod.MembershipService(range(self.domain.n_nodes))

    def _sync_holds(self, stream, view, round_no: int):
        """Pin each pending hold to its last app message's publish index
        (:meth:`GroupStream.app_publish_index` — None while that message
        is still window-throttled) and release holds the delivery
        watermark has passed."""
        for g in range(len(self.engines)):
            watermark = view.sender_delivered(g)
            for slot in list(self._holds[g]):
                hold = self._holds[g][slot]
                rank = self._slot_rank[g][slot]   # holds live on live slots
                if hold.last_idx is None:
                    hold.last_idx = stream.app_publish_index(
                        g, rank, hold.target_apps)
                if hold.last_idx is not None and \
                        watermark[rank] > hold.last_idx:
                    del self._holds[g][slot]
                    self.free_rounds.append((g, slot, round_no))

    def _fail_nodes(self, bound: dds.BoundDomain,
                    waves: Sequence[Sequence[int]], round_no: int,
                    admission: Optional[ServeAdmission]
                    ) -> dds.BoundDomain:
        """Install ONE new view without the given nodes — subscribers
        and/or slot (publisher) nodes, possibly in cascading suspicion
        waves — and carry the serve state across the cut.

        **Cascade folding.**  ``waves[0]`` is the suspicion batch that
        triggers the wedge; each later wave lands *while the wedge is in
        progress* and folds into the same pending cut via
        :meth:`views.MembershipService.propose_and_install`'s
        ``during_wedge`` hook — exactly one view installs for the whole
        cascade, its trim computed over the final survivors.

        **Surviving slots.**  The cut restarts per-sender publish
        numbering, so a hold's ``target_apps`` is rebased by the apps
        that went STABLE at the cut (``EpochCarry.stable_apps``): if its
        last message was already delivered everywhere the hold frees
        here; otherwise the remainder rides the resend backlog and the
        hold re-pins from the new epoch's traces.  The engine-side
        enqueued counters rebase identically.

        **Dead slots.**  A failed slot node's messages up to the ragged
        trim were delivered at every survivor (the closing report's
        ``stable_apps_by_old_rank``); its unstable tail dies with it.
        Its hold is dropped.  An in-flight decode is VOIDED
        (:meth:`ServeEngine.evict`): the request re-enters the head of
        the replica's queue to restart from its prompt on a surviving
        slot, or is shed if the queue is at ``queue_cap``.  Surviving
        slots compact, in slot order, onto the new view's sender ranks.
        Raises if a replica would lose its last live slot.

        Every event lands in :attr:`slot_failures`; each installed view
        is appended to :attr:`view_log` and its wall clock to
        :attr:`cut_walls`."""
        t0 = time.perf_counter()
        waves = [sorted(set(w)) for w in waves if w]
        failing = set().union(*[set(w) for w in waves])
        dead_by_g: Dict[int, set] = {}
        for n in failing:
            if n in self._node_to_slot:
                g, s = self._node_to_slot[n]
                dead_by_g.setdefault(g, set()).add(s)
        for g, dead in dead_by_g.items():
            if len(self._dead_slots[g] | dead) >= self._slots[g]:
                raise ValueError(
                    f"fail_at round {round_no} would kill every slot "
                    f"node of replica {g}: the engine would have no "
                    "publisher lane left — a full-replica failure is a "
                    "domain teardown, not a view change")
        ms = self._ms
        reporter = next((m for m in ms.view.members if m not in failing),
                        ms.view.members[0])
        for n in waves[0]:
            ms.suspect(reporter, n)

        def _during_wedge(svc, attempt):
            nxt = attempt + 1
            if nxt < len(waves):
                for n in waves[nxt]:
                    svc.suspect(reporter, n)

        old_rank_slot = [list(r) for r in self._rank_slot]
        view = ms.propose_and_install(
            {}, during_wedge=_during_wedge if len(waves) > 1 else None)
        new_bound, old_report, old_logs = bound.reconfigure(view)
        carry = new_bound.stream.carry
        stable_old = \
            old_report.extras["view_change"]["stable_apps_by_old_rank"]
        for g, eng in enumerate(self.engines):
            # dead slots first: account their stable prefix, void the
            # in-flight decode, drop their hold
            for slot in sorted(dead_by_g.get(g, ())):
                old_rank = old_rank_slot[g].index(slot)
                stable_cnt = int(stable_old[g][old_rank])
                rec = {"round": round_no, "replica": g, "slot": slot,
                       "node": self._slot_nodes[g][slot],
                       "stable_apps": stable_cnt,
                       "lost_apps":
                           int(self._apps_enqueued[g][slot]) - stable_cnt,
                       "voided_rid": None, "requeued": False,
                       "hold_dropped": slot in self._holds[g]}
                self._holds[g].pop(slot, None)
                req = eng.evict(slot)
                if req is not None:
                    rec["voided_rid"] = req.rid
                    if (admission is not None
                            and admission.queue_cap is not None
                            and len(eng.queue) >= admission.queue_cap):
                        self.shed_log.append((req.rid, round_no))
                    else:
                        eng.queue.appendleft(req)  # oldest work first
                        rec["requeued"] = True
                self._apps_enqueued[g][slot] = 0
                self._dead_slots[g].add(slot)
                self.slot_failures.append(rec)
            self._rank_slot[g] = [s for s in range(self._slots[g])
                                  if s not in self._dead_slots[g]]
            self._slot_rank[g] = {s: r for r, s in
                                  enumerate(self._rank_slot[g])}
            # surviving slots: rebase by what went stable at the cut
            stable = carry.stable_apps[g]
            for new_rank, slot in enumerate(self._rank_slot[g]):
                d = int(stable[new_rank])
                self._apps_enqueued[g][slot] -= d
                hold = self._holds[g].get(slot)
                if hold is not None:
                    hold.target_apps -= d
                    hold.last_idx = None        # old-epoch index is void
                    if hold.target_apps <= 0:   # stable at the cut: free
                        del self._holds[g][slot]
                        self.free_rounds.append((g, slot, round_no))
        self.view_log.append((round_no, view, old_report, old_logs))
        self.cut_walls.append(time.perf_counter() - t0)
        self._last_view = None       # old-epoch watermarks are void
        return new_bound

    # -- the serve+multicast loop --------------------------------------------

    def submit(self, replica: int, req) -> None:
        self.engines[replica].submit(req)

    def run(self, *, max_rounds: int = 10_000,
            settle_max: Optional[int] = None,
            fail_at: Optional[Mapping[int, Sequence[int]]] = None,
            arrive_fn: Optional[ArriveFn] = None,
            arrive_schedule: Optional[Sequence[Sequence[
                Sequence[Request]]]] = None,
            arrive_rounds: int = 0,
            admission: Optional[ServeAdmission] = None,
            fused: bool = False
            ) -> RunReport:
        """Drive every replica to drain, one multicast round per engine
        round, then settle the multicast and return the merged report.

        Every engine round is ONE stacked stream round across all G
        replica topics.  Admission into a freed slot is gated on the
        delivery watermark; requests queue behind held slots rather than
        overwrite undelivered ring state.

        Open-loop driving: ``arrive_fn(g, round)`` (or its tabulated form
        ``arrive_schedule[round][g]``) injects that round's arriving
        requests into replica ``g``'s queue for the first
        ``arrive_rounds`` rounds — the loop keeps stepping through
        momentary drains while arrivals are still due.  ``admission``
        bounds the response to overload: queue tails beyond
        ``queue_cap`` are SHED (recorded in :attr:`shed_log`), and a slot
        whose multicast lane has more than ``stall_backlog`` messages in
        flight (read off the previous round's watermarks) decodes a null
        round.

        ``fail_at`` maps an engine round to node ids that fail after
        that round's multicast round — SUBSCRIBER nodes and/or SLOT
        (publisher) nodes, in any mix: the serve plane survives the
        mid-stream view change through the virtual-synchrony cut
        (:meth:`_fail_nodes`).  In-flight admissions/tokens are delivered
        everywhere at the ragged trim or resent in the new view's
        stream; every pending slot hold is re-pinned against the new
        epoch's watermarks; a dead slot node's unstable tail dies with
        it, its in-flight decode is voided and the request re-admitted
        or shed.  A value may also be a sequence of node sequences —
        *cascading suspicion waves* that land while the wedge is in
        progress and fold into ONE installed view.  Each installed view
        is recorded in :attr:`view_log` with the closing epoch's report
        and cut-clipped per-topic logs; slot-kill events in
        :attr:`slot_failures`.  Scheduled rounds the run never reaches
        surface in ``extras["serve"]["fail_at_unreached"]``.

        ``fused=True`` executes each membership epoch as one device
        program (:mod:`repro_torch.serve.fused`: one round captured as a
        CUDA graph and replayed, its control flow decided on the device),
        with zero host hops between rounds
        (``extras["serve"]["host_hops"] == 0``).  ``fail_at`` stops the
        fused loop at the failure round, performs the SAME host-side cut
        as this loop (:meth:`_fail_nodes`), and runs the next epoch's
        program with the resend as its initial backlog.  Precomputed
        dynamics stay fused: ``arrive_schedule``, ``ServeAdmission``,
        ndarray stall masks and homogeneous cuts.  Arbitrary
        ``arrive_fn`` / ``stall_fn`` callbacks, ``settle_max``,
        heterogeneous replicas or cuts, and a first epoch that overflows
        the fused round budget run this per-round loop instead (results
        identical); then ``extras["serve"]["fused"]`` is False and
        ``extras["serve"]["fused_fallback"]`` names the reason."""
        if arrive_schedule is not None and arrive_fn is not None:
            raise ValueError(
                "arrive_schedule and arrive_fn are mutually exclusive: "
                "a schedule IS the precomputed form of the callback")
        if arrive_schedule is not None and arrive_rounds <= 0:
            arrive_rounds = len(arrive_schedule)
        fail_at = {int(r): _as_waves(spec)
                   for r, spec in (fail_at or {}).items()}
        fail_at = {r: w for r, w in fail_at.items() if w}
        fused_fallback: Optional[str] = None
        if fused:
            from repro_torch.serve import fused as fused_mod
            fused_fallback = fused_mod.fused_fallback_reason(
                self, fail_at=fail_at, arrive_fn=arrive_fn,
                arrive_schedule=arrive_schedule, admission=admission,
                settle_max=settle_max)
            if fused_fallback is None:
                try:
                    report = fused_mod.run_fused(
                        self, max_rounds=max_rounds, fail_at=fail_at,
                        arrive_schedule=arrive_schedule,
                        arrive_rounds=arrive_rounds,
                        admission=admission)
                except fused_mod.FusedUnsupported as e:
                    report, fused_fallback = None, str(e)
                if report is not None:
                    return report
                fused_fallback = fused_fallback or (
                    "run overflowed the fused round budget")
        # a precomputed schedule / stall mask is just the tabulated form
        # of the callback
        if arrive_schedule is not None:
            sched = [list(row) for row in arrive_schedule]
            arrive_fn = (lambda g, rnd:
                         sched[rnd][g] if rnd < len(sched) else ())
        stall_fn = self.stall_fn
        if isinstance(stall_fn, np.ndarray):
            stall_arr = stall_fn.astype(bool)
            stall_fn = (lambda g, rnd:
                        np.nonzero(stall_arr[rnd, g])[0]
                        if rnd < stall_arr.shape[0] else ())
        self._reset_run_state()
        bound = self.domain.bind(backend=self.backend, device=self.device)
        wall0 = time.perf_counter()
        # serve metrics are per-RUN deltas: engines accumulate completed
        # requests across runs (reset() clears them)
        tok0 = sum(len(r.tokens_out) for eng in self.engines
                   for r in eng.completed)
        req0 = sum(len(eng.completed) for eng in self.engines)
        steps0 = sum(eng.decode_steps for eng in self.engines)
        syncs0 = sum(eng.host_syncs for eng in self.engines)
        round_no = 0
        while (round_no < max_rounds
               and (round_no < arrive_rounds
                    or not all(eng.drained() for eng in self.engines))):
            if arrive_fn is not None and round_no < arrive_rounds:
                for g in range(len(self.engines)):
                    for req in arrive_fn(g, round_no) or ():
                        self.submit(g, req)
                        self.submit_rounds[req.rid] = round_no
            if admission is not None and admission.queue_cap is not None:
                for eng in self.engines:
                    while len(eng.queue) > admission.queue_cap:
                        dropped = eng.queue.pop()   # shed the tail
                        self.shed_log.append((dropped.rid, round_no))
            self.queue_depth_log.append(
                sum(len(eng.queue) for eng in self.engines))
            counts_by_topic = {}
            for g, eng in enumerate(self.engines):
                stalled = set(int(s) for s in stall_fn(g, round_no)) \
                    if stall_fn is not None else set()
                if (admission is not None
                        and admission.stall_backlog is not None
                        and self._last_view is not None):
                    v, k = self._last_view, len(self._rank_slot[g])
                    inflight = (v.published[g, :k]
                                - v.sender_delivered(g)[:k]
                                + v.backlog[g, :k])
                    stalled |= {self._rank_slot[g][int(r)] for r in
                                np.nonzero(inflight
                                           > admission.stall_backlog)[0]}
                held = self._holds[g]
                dead = self._dead_slots[g]
                mask = [s not in held and s not in dead
                        for s in range(self._slots[g])]
                info = eng.step(stalled=tuple(sorted(stalled)),
                                admit_mask=mask)
                self.stall_rounds += len(info.stalled)
                # counts are indexed by the CURRENT view's sender ranks
                # (surviving slots compacted in slot order)
                c = np.zeros(len(self._rank_slot[g]), np.int64)
                rank = self._slot_rank[g]
                for slot, rid in zip(info.admitted, info.admitted_rids):
                    c[rank[slot]] += 1         # the admitted-request batch
                    self.admit_rounds[rid] = round_no
                    self.admit_slots[rid] = (g, slot)
                for slot in info.emitted:
                    c[rank[slot]] += 1         # the emitted token
                    self._apps_enqueued[g][slot] += 1
                for slot in info.admitted:
                    self._apps_enqueued[g][slot] += 1
                for slot in info.finished:
                    self._holds[g][slot] = _SlotHold(
                        target_apps=int(self._apps_enqueued[g][slot]),
                        finished_round=round_no)
                    self.finish_rounds.append((g, slot, round_no))
                for rid in info.finished_rids:
                    self.finish_round_by_rid[rid] = round_no
                counts_by_topic[self.topics[g].name] = c
            view = bound.push_round(counts_by_topic)
            self._last_view = view
            self.backlog_log.append(int(sum(
                int(view.backlog[g, :len(self._rank_slot[g])].sum())
                for g in range(len(self.engines)))))
            self._sync_holds(bound.stream, view, round_no)
            if round_no in fail_at:
                bound = self._fail_nodes(bound, fail_at[round_no],
                                         round_no, admission)
            round_no += 1
        # a scheduled failure the run never reached became moot (an
        # earlier cut or the drain landed first): surface it, not raise
        unreached = sorted(r for r in fail_at if r >= round_no)
        report, logs = bound.finish(settle_max=settle_max)
        # release holds the settle rounds delivered — including holds
        # whose last app message was still window-throttled when the
        # engines drained (unpinned): by quiescence it has published
        self._sync_holds(bound.stream, bound.stream.view(), round_no)
        wall = time.perf_counter() - wall0
        tokens = sum(len(r.tokens_out) for eng in self.engines
                     for r in eng.completed) - tok0
        report.extras["delivery_logs"] = logs
        report.extras["serve"] = {
            "replicas": len(self.engines),
            "engine_rounds": round_no,
            # False = max_rounds exhausted with work still queued/in
            # flight; the report then covers only what was served
            "drained": all(eng.drained() for eng in self.engines),
            "decode_steps": sum(e.decode_steps
                                for e in self.engines) - steps0,
            "requests": sum(len(e.completed)
                            for e in self.engines) - req0,
            "tokens": tokens,
            "tokens_per_s": tokens / wall if wall > 0 else 0.0,
            "stall_rounds": self.stall_rounds,
            "held_slots": sum(len(h) for h in self._holds),
            "view_changes": len(self.view_log),
            "slot_failures": len(self.slot_failures),
            "voided_requests": sum(1 for r in self.slot_failures
                                   if r["voided_rid"] is not None),
            "requeued_requests": sum(1 for r in self.slot_failures
                                     if r["requeued"]),
            "slot_failure_log": list(self.slot_failures),
            "fail_at_unreached": unreached,
            "shed_requests": len(self.shed_log),
            "max_queue_depth": max(self.queue_depth_log, default=0),
            "max_backlog": max(self.backlog_log, default=0),
            "wall_s": wall,
            "fused": False,
            # device->host syncs taken INSIDE the round loop: one token-id
            # readback per engine decode + one watermark read per
            # multicast round
            "host_hops": (sum(eng.host_syncs for eng in self.engines)
                          - syncs0) + round_no,
        }
        if fused_fallback is not None:
            report.extras["serve"]["fused_fallback"] = fused_fallback
        self.last_report = report
        return report

    # -- results -------------------------------------------------------------

    def completed(self) -> Dict[int, List[List[int]]]:
        """Per replica: token streams of completed requests in rid order
        (accumulated since the last :meth:`reset`)."""
        return {g: [r.tokens_out for r in
                    sorted(eng.completed, key=lambda r: r.rid)]
                for g, eng in enumerate(self.engines)}

    def reset(self) -> None:
        """Reset every replica engine (keeps params and caches)."""
        for eng in self.engines:
            eng.reset()
