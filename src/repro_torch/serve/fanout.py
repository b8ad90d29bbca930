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
Mid-run failures (``fail_at``) and the fused one-program loop
(``fused=True``) come with later slices of the port and raise here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import dds
from repro_torch.core.group import (CUT_ITEM, FUSED_ITEM, RunReport,
                                    not_ported)
from repro_torch.load.admission import ServeAdmission
from repro_torch.serve.engine import Request, ServeEngine

# stall_fn(replica, engine_round) -> slots whose client is backpressured
StallFn = Callable[[int, int], Sequence[int]]

# arrive_fn(replica, engine_round) -> requests arriving open-loop that
# round
ArriveFn = Callable[[int, int], Sequence[Request]]


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
        self._reset_run_state()
        self.last_report: Optional[RunReport] = None

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

    def _sync_holds(self, stream, view, round_no: int):
        """Pin each pending hold to its last app message's publish index
        (:meth:`GroupStream.app_publish_index` — None while that message
        is still window-throttled) and release holds the delivery
        watermark has passed."""
        for g in range(len(self.engines)):
            watermark = view.sender_delivered(g)
            for slot in list(self._holds[g]):
                hold = self._holds[g][slot]
                if hold.last_idx is None:
                    hold.last_idx = stream.app_publish_index(
                        g, slot, hold.target_apps)
                if hold.last_idx is not None and \
                        watermark[slot] > hold.last_idx:
                    del self._holds[g][slot]
                    self.free_rounds.append((g, slot, round_no))

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

        ``fail_at`` (mid-run node failures through the virtual-synchrony
        cut) and ``fused=True`` (the whole run as one device program)
        raise ``NotImplementedError``: they come with later slices."""
        if fail_at:
            raise not_ported("ReplicatedEngine.run(fail_at=...)", CUT_ITEM)
        if fused:
            raise not_ported("ReplicatedEngine.run(fused=True)", FUSED_ITEM)
        if arrive_schedule is not None and arrive_fn is not None:
            raise ValueError(
                "arrive_schedule and arrive_fn are mutually exclusive: "
                "a schedule IS the precomputed form of the callback")
        if arrive_schedule is not None and arrive_rounds <= 0:
            arrive_rounds = len(arrive_schedule)
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
                    v, k = self._last_view, self._slots[g]
                    inflight = (v.published[g, :k]
                                - v.sender_delivered(g)[:k]
                                + v.backlog[g, :k])
                    stalled |= {int(s) for s in np.nonzero(
                        inflight > admission.stall_backlog)[0]}
                held = self._holds[g]
                mask = [s not in held for s in range(self._slots[g])]
                info = eng.step(stalled=tuple(sorted(stalled)),
                                admit_mask=mask)
                self.stall_rounds += len(info.stalled)
                c = np.zeros(self._slots[g], np.int64)
                for slot, rid in zip(info.admitted, info.admitted_rids):
                    c[slot] += 1               # the admitted-request batch
                    self.admit_rounds[rid] = round_no
                    self.admit_slots[rid] = (g, slot)
                for slot in info.emitted:
                    c[slot] += 1               # the emitted token
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
                int(view.backlog[g, :self._slots[g]].sum())
                for g in range(len(self.engines)))))
            self._sync_holds(bound.stream, view, round_no)
            round_no += 1
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
            # view changes and slot failures come with the cut
            # (ROADMAP.md item 5): none can happen in this loop
            "view_changes": 0,
            "slot_failures": 0,
            "voided_requests": 0,
            "requeued_requests": 0,
            "slot_failure_log": [],
            "fail_at_unreached": [],
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
