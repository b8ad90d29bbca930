"""Elastic runtime: virtual-synchrony views driving mesh/loader/checkpoint
reconfiguration (fault tolerance at 1000+ node scale).

The control flow on a real cluster (and, deterministically, in tests):

  1. every worker heartbeats by bumping a monotone SST counter; a stalled
     counter triggers ``MembershipService.suspect`` (straggler detection
     uses the same watermark with a softer threshold -> null-rounds first,
     eviction only if the lag persists);
  2. the surviving leader runs the two-phase monotone view change
     (wedge -> watermark agreement -> install);
  3. every member of the new view restores from the checkpoint watermark
     (``delivered_step``), rebuilds the mesh with the new DP extent and
     re-partitions the deterministic data stream (repro_torch.data.pipeline);
  4. training resumes; steps beyond the watermark that some old members
     had locally applied are recomputed — exactly virtual synchrony's
     "deliver everywhere or nowhere, resend in the next view".

The in-process harness below exercises all of that logic with simulated
failures so it is testable on one CPU.

With a gradient stream attached (:meth:`ElasticRuntime
.attach_gradient_stream` ->
:class:`repro_torch.core.gradsync.BucketSyncStream`) step 3 changes
character: the resize is a real virtual-synchrony CUT — wedge, ragged
trim, ``EpochCarry`` resend (DESIGN.md Sec. 7) — in-flight bucket
rounds survive the view change instead of being recomputed, and
``delivered_step`` tracks the stream's monotone applied watermark (no
rollback).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.views import MembershipService, View


@dataclasses.dataclass
class WorkerState:
    """Host-side per-worker runtime state (the SST row, host edition)."""

    node: int
    heartbeat: int = 0            # monotone; bumped every local step
    delivered_step: int = 0       # last optimizer step known applied
    alive: bool = True
    lag: int = 0                  # straggler rounds covered by null-rounds


@dataclasses.dataclass
class ElasticConfig:
    heartbeat_timeout: int = 5      # missed beats -> suspected failed
    straggler_threshold: int = 2    # missed beats -> null-round instead
    checkpoint_every: int = 20


class ElasticRuntime:
    """Deterministic elastic-training control loop."""

    def __init__(self, members: List[int],
                 cfg: ElasticConfig = ElasticConfig()):
        self.cfg = cfg
        self.membership = MembershipService(members)
        self.workers: Dict[int, WorkerState] = {
            m: WorkerState(node=m) for m in members}
        self.round = 0
        self.view_changes: List[View] = []
        # optional multicast gradient plane (attach_gradient_stream)
        self.gradsync = None
        self._update_fn: Optional[Callable[[int, int], Any]] = None

    @property
    def view(self) -> View:
        return self.membership.view

    def fail(self, node: int):
        self.workers[node].alive = False

    def delay(self, node: int, rounds: int):
        self.workers[node].lag += rounds

    def join(self, node: int):
        self.membership.request_join(node)
        self.workers.setdefault(node, WorkerState(node=node))

    def attach_gradient_stream(self, gradsync,
                               update_fn: Callable[[int, int], Any]):
        """Route this runtime's rounds through a
        :class:`repro_torch.core.gradsync.BucketSyncStream`: each round's
        contributors publish ``update_fn(node, round)`` as fused bucket
        messages, updates apply in the multicast total order once
        delivered everywhere, and a resize becomes a REAL
        virtual-synchrony cut — wedge, ragged trim, ``EpochCarry``
        resend (DESIGN.md Sec. 7) — instead of the rollback-to-watermark
        restart below: a survivor's in-flight buckets are resent in the
        new view, a dead worker's unstable tail is voided, and no
        worker's ``delivered_step`` ever rolls back."""
        self.gradsync = gradsync
        self._update_fn = update_fn

    def step(self) -> Dict[str, Any]:
        """One global training round: returns which members contributed,
        who null-rounded, and whether a view change happened."""
        self.round += 1
        view = self.view
        contributed, nulls = [], []
        for m in view.members:
            w = self.workers[m]
            if not w.alive:
                continue
            if w.lag > 0:
                w.lag -= 1
                nulls.append(m)       # null-round: the Sec. 3.3 adaptation
                w.heartbeat += 1      # still alive, just slow
                continue
            w.heartbeat += 1
            if self.gradsync is None:
                w.delivered_step += 1
            contributed.append(m)
        if self.gradsync is not None:
            # publish this round's bucket set; delivered_step advances
            # with the stream's applied watermark, not local application
            self.gradsync.contribute({
                m: self._update_fn(m, self.round) for m in contributed})
            applied = self.gradsync.applied_step
            for m in view.members:
                w = self.workers[m]
                if w.alive:
                    w.delivered_step = max(w.delivered_step, applied)
        # failure detection from heartbeat watermarks
        expect = max((self.workers[m].heartbeat for m in view.members
                      if self.workers[m].alive), default=0)
        for m in view.members:
            w = self.workers[m]
            if not w.alive or expect - w.heartbeat >= \
                    self.cfg.heartbeat_timeout:
                for reporter in view.members:
                    if self.workers[reporter].alive:
                        self.membership.suspect(reporter, m)
        changed = None
        if self.membership.needs_change():
            committed = {m: self.workers[m].delivered_step
                         for m in view.members if self.workers[m].alive}
            if self.gradsync is not None:
                # a REAL cut: the stream wedges and trims, survivors'
                # in-flight buckets become resend backlog, and nobody's
                # delivered_step moves backwards — the applied watermark
                # is monotone across the cut by construction
                changed, self.gradsync = \
                    self.membership.reconfigure_stream(self.gradsync,
                                                       committed)
                self.view_changes.append(changed)
                applied = self.gradsync.applied_step
                beat = max((self.workers[n].heartbeat
                            for n in changed.members
                            if n in self.workers), default=0)
                for m in changed.members:
                    w = self.workers.setdefault(m, WorkerState(node=m))
                    w.delivered_step = max(w.delivered_step, applied)
                    w.heartbeat = beat
            else:
                changed = self.membership.propose_and_install(committed)
                self.view_changes.append(changed)
                watermark = self.membership.restart_watermark()
                for m in changed.members:
                    w = self.workers.setdefault(m, WorkerState(node=m))
                    # virtual-synchrony cleanup: roll back past the
                    # watermark (the restart-style path, kept for
                    # runtimes without a gradient stream attached)
                    w.delivered_step = watermark
                    w.heartbeat = max(self.workers[n].heartbeat
                                      for n in changed.members
                                      if n in self.workers)
        return {
            "round": self.round,
            "contributed": contributed,
            "null_rounds": nulls,
            "view_change": changed.vid if changed else None,
            "dp_size": len(self.view.members),
            "applied_step": (self.gradsync.applied_step
                             if self.gradsync is not None else None),
        }

    def restart_watermark(self) -> int:
        return self.membership.restart_watermark()
