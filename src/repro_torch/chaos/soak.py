"""Seeded chaos soaks: drive a live target through a sampled fault
schedule under load-plane traffic and assert the virtual-synchrony
invariants after EVERY installed view (DESIGN.md Sec. 7).

:func:`chaos_soak` dispatches on the target:

* a :class:`~repro_torch.core.group.Group` / ``GroupStream`` — streamed
  multicast traffic with suspicions (optionally cascading mid-wedge),
  joins, and stall bursts; checks per cut: monotone node-keyed
  ``app_base``, the conservation law ``app_base + resend ==
  cumulative enqueued`` per surviving sender, everywhere-or-nowhere
  epoch logs, per-sender FIFO, and
  :func:`repro_torch.core.sst.cascading_trim` monotonicity over the
  cascade's survivor stages; at the end, exactly-once for every live
  sender and lost-tail-only for dead ones.
* a :class:`~repro_torch.serve.fanout.ReplicatedEngine` — a sampled
  ``fail_at`` schedule mixing subscriber kills, slot-node kills, and
  cascading waves over pre-submitted requests; checks the engines
  drain, epoch logs agree at every surviving subscriber, each epoch
  delivers exactly its stable prefix, and completed/shed partition the
  submitted work.
* a :class:`~repro_torch.core.gradsync.BucketSyncStream` — optimizer rounds
  with kills/joins/stall rounds; checks the applied ledger is in step
  order with no gaps, voided contributions only ever belong to dead
  workers, and the per-node stable base is monotone across cuts.

Every check that fails raises :class:`InvariantViolation` (an
``AssertionError`` subclass, so plain ``pytest`` machinery reports it);
the returned :class:`ChaosReport` carries comparable digests in
``extras`` so a test can run the same seed on ``kernel`` and ``graph``
(and against the reference package's soak) and assert the reports are
bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.chaos.faults import FaultEvent, FaultSpec, events_by_round
from repro_torch.core import group as group_mod
from repro_torch.core import sst
from repro_torch.core import views as views_mod
from repro_torch.core.gradsync import BucketSyncStream


class InvariantViolation(AssertionError):
    """A chaos-soak invariant failed (exactly-once / FIFO / monotone
    ``app_base`` / everywhere-or-nowhere).  The message carries the
    seed, the round, and the failing arithmetic — enough to replay."""


@dataclasses.dataclass
class ChaosReport:
    """What one soak did and verified.  ``extras`` holds plain-data
    digests (delivery sequences, per-node app counts, applied rounds)
    that must be bit-identical for the same seed across ``graph`` and
    ``kernel``, on any device."""

    target: str                       # "stream" | "serve" | "gradsync"
    seed: int
    backend: str
    rounds: int
    views_installed: int
    wedge_retries: int
    killed: Tuple[int, ...]
    joined: Tuple[int, ...]
    stall_rounds: int
    checks: int                       # invariant assertions that ran
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _Checker:
    """Counts assertions so a report can prove the soak actually
    checked something (a soak whose schedule drew zero faults still
    runs the end-state checks)."""

    def __init__(self, seed: int):
        self.seed = seed
        self.n = 0

    def __call__(self, cond: bool, msg: str, *ctx):
        self.n += 1
        if not cond:
            raise InvariantViolation(
                f"[seed={self.seed}] {msg}"
                + (f" :: {ctx}" if ctx else ""))


def _fifo_apps(log, node) -> Dict[int, int]:
    """Delivered app count per sender RANK at ``node``, asserting
    per-sender FIFO (publish indices strictly increasing) on the way."""
    counts: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for rank, idx, _ in log.sequence(node):
        if idx <= last.get(rank, -1):
            raise InvariantViolation(
                f"per-sender FIFO violated at node {node}: rank {rank} "
                f"idx {idx} after {last[rank]}")
        last[rank] = idx
        counts[rank] = counts.get(rank, 0) + 1
    return counts


def _waves_of(ev: FaultEvent) -> List[List[int]]:
    return [list(ev.nodes)] + [list(w) for w in ev.cascade]


# ---------------------------------------------------------------------------
# stream soak
# ---------------------------------------------------------------------------

def _soak_stream(target, spec: FaultSpec, seed: int,
                 backend: str) -> ChaosReport:
    rng = np.random.default_rng(seed)
    check = _Checker(seed)
    if isinstance(target, group_mod.GroupStream):
        stream = target
    else:
        stream = target.stream(backend=backend)
    cfg = stream.group.cfg
    # survivability floor: the first member and first sender of every
    # subgroup (plus the reporter) are never killable, so no subgroup
    # loses all members or all senders and gid numbering stays put
    protected = {cfg.members[0]}
    for sg in cfg.subgroups:
        protected.add(sg.members[0])
        protected.add(sg.senders[0])
    reporter = cfg.members[0]
    killable = [m for m in cfg.members if m not in protected]
    joinable = [max(cfg.members) + 1 + i for i in range(3)]
    schedule = spec.sample(rng, killable=killable, joinable=joinable)
    by_round = events_by_round(schedule)

    ms = views_mod.MembershipService(cfg.members)
    cum_enq: Dict[Tuple[int, int], int] = {}      # (gid, node) -> apps
    prev_base: Dict[Tuple[int, int], int] = {}
    cum_delivered: Dict[Tuple[int, int], int] = {}
    killed: List[int] = []
    joined: List[int] = []
    stall_left = 0
    stall_rounds = 0
    epoch_digests: List[Any] = []
    trim_stages: List[List[int]] = []

    def _account_epoch(old_group, alive: set) -> None:
        """Check one closed epoch: everywhere-or-nowhere + per-sender
        FIFO on its logs, and fold its delivered app counts into the
        cumulative node-keyed ledger the carry checks reconcile."""
        specs = old_group.cfg.subgroups
        logs = old_group.delivery_logs
        digest = []
        for gid, sg in enumerate(specs):
            log = logs[gid]
            survivors = [m for m in sg.members if m in alive]
            check(bool(survivors),
                  "epoch closed with no surviving members", gid)
            seqs = [log.sequence(m) for m in survivors]
            for s in seqs[1:]:
                check(s == seqs[0],
                      "everywhere-or-nowhere violated: surviving "
                      "members disagree on the epoch log", gid)
            per_rank = _fifo_apps(log, survivors[0])
            check.n += 1                           # the FIFO pass itself
            for rank, c in per_rank.items():
                node = sg.senders[rank]
                key = (gid, node)
                cum_delivered[key] = cum_delivered.get(key, 0) + c
            digest.append(tuple(seqs[0]))
        epoch_digests.append(tuple(digest))

    n_events = 0
    for rnd in range(spec.rounds):
        ready = np.zeros(stream.shape, np.int32)
        if stall_left > 0:
            stall_left -= 1
            stall_rounds += 1                      # pure null round
        else:
            for g, sg in enumerate(stream.group.cfg.subgroups):
                for rank, node in enumerate(sg.senders):
                    if node in killed:
                        continue
                    c = int(rng.integers(0, 3))
                    ready[g, rank] = c
                    key = (g, node)
                    cum_enq[key] = cum_enq.get(key, 0) + c
        stream.step(ready)

        evs = by_round.get(rnd, ())
        waves: List[List[int]] = []
        membership_dirty = False
        for ev in evs:
            if ev.kind == "stall":
                stall_left = max(stall_left, ev.length)
            elif ev.kind == "join":
                for n in ev.nodes:
                    ms.request_join(n)
                    joined.append(n)
                membership_dirty = True
            elif ev.kind in ("suspect", "slot_kill"):
                waves.extend(_waves_of(ev))
                membership_dirty = True
        if not membership_dirty:
            continue
        n_events += 1
        for w in waves:
            killed.extend(w)
        # exercise the cascade trim arithmetic against the live SST
        # snapshot: each wave only shrinks survivors, so the staged
        # trims are monotone non-decreasing (sst.cascading_trim)
        received = stream._states.received_num.cpu().numpy()
        alive_now = set(ms.view.members)
        for g, sg in enumerate(stream.group.cfg.subgroups):
            dead_acc: set = set()
            stages = []
            for w in (waves or [[]]):
                dead_acc |= set(w)
                stages.append([m in alive_now and m not in dead_acc
                               for m in sg.members])
            trims = sst.cascading_trim(
                received[g, : len(sg.members)], stages)
            for a, b in zip(trims, trims[1:]):
                check(b >= a, "cascading trim rolled a watermark back",
                      rnd, g, trims)
            trim_stages.append(trims)
        if waves:
            for n in waves[0]:
                ms.suspect(reporter, n)

        def _during_wedge(svc, attempt, _waves=waves):
            nxt = attempt + 1
            if nxt < len(_waves):
                for n in _waves[nxt]:
                    svc.suspect(reporter, n)

        old_group = stream.group
        view, stream = ms.reconfigure_stream(
            stream, {},
            during_wedge=_during_wedge if len(waves) > 1 else None)
        carry = stream.carry
        alive = set(view.members)
        _account_epoch(old_group, alive)
        # per-cut invariants on the carry, keyed by NODE (rank maps
        # change across cuts; node identity is the stable key)
        for g, sg in enumerate(stream.group.cfg.subgroups):
            for rank, node in enumerate(sg.senders):
                key = (g, node)
                base = int(carry.app_base[g][rank])
                check(base >= prev_base.get(key, 0),
                      "app_base rolled back across the cut", rnd, key)
                prev_base[key] = base
                check(base + int(carry.resend[g][rank])
                      == cum_enq.get(key, 0),
                      "conservation violated: stable base + resend "
                      "backlog != total enqueued", rnd, key,
                      base, int(carry.resend[g][rank]),
                      cum_enq.get(key, 0))
                check(cum_delivered.get(key, 0) == base,
                      "delivered-so-far disagrees with the carry's "
                      "cumulative stable base", rnd, key)

    report, _logs = stream.finish()
    check(not report.stalled, "final epoch stalled short of its target")
    _account_epoch(stream.group, set(ms.view.members))
    for (g, node), total in cum_enq.items():
        got = cum_delivered.get((g, node), 0)
        if node in killed:
            check(got <= total,
                  "dead sender delivered MORE than it enqueued",
                  g, node)
        else:
            check(got == total,
                  "exactly-once violated for a live sender",
                  g, node, got, total)
    return ChaosReport(
        target="stream", seed=seed, backend=backend, rounds=spec.rounds,
        views_installed=len(ms.history) - 1, wedge_retries=ms.wedge_retries,
        killed=tuple(killed), joined=tuple(joined),
        stall_rounds=stall_rounds, checks=check.n,
        extras={
            "delivered": {f"{g}:{n}": c
                          for (g, n), c in sorted(cum_delivered.items())},
            "enqueued": {f"{g}:{n}": c
                         for (g, n), c in sorted(cum_enq.items())},
            "epoch_digests": epoch_digests,
            "trim_stages": trim_stages,
            "fault_events": n_events,
        })


# ---------------------------------------------------------------------------
# serve soak
# ---------------------------------------------------------------------------

def _soak_serve(engine, spec: FaultSpec, seed: int,
                fused: bool = False) -> ChaosReport:
    rng = np.random.default_rng(seed)
    check = _Checker(seed)
    submitted = [req.rid for eng in engine.engines for req in eng.queue]
    if not submitted:
        raise ValueError(
            "chaos_soak over a ReplicatedEngine needs pre-submitted "
            "requests (engine.submit(replica, req) before the soak)")
    # subscribers: keep the FIRST of every topic so each epoch always
    # has a log to read; slot nodes: FaultSpec keeps >= 1 live per
    # replica by construction (it only draws while a group has > 1)
    killable = [s for t in engine.topics for s in t.subscribers[1:]]
    slot_groups = [list(nodes) for nodes in engine._slot_nodes]
    schedule = spec.sample(rng, killable=killable,
                           slot_groups=slot_groups)
    fail_at: Dict[int, List[List[int]]] = {}
    stall_at: Dict[int, int] = {}
    killed: List[int] = []
    for ev in schedule:
        if ev.kind == "stall":
            stall_at[ev.round] = max(stall_at.get(ev.round, 0),
                                     ev.length)
        elif ev.kind in ("suspect", "slot_kill"):
            ws = _waves_of(ev)
            fail_at.setdefault(ev.round, []).extend(ws)
            for w in ws:
                killed.extend(w)

    old_stall = engine.stall_fn
    stall_rounds_set = {r + k for r, ln in stall_at.items()
                        for k in range(ln)}
    # stall bursts as a precomputed (rounds, G, slots) mask — the form
    # the fused program reads on the device (a host closure would force
    # the per-round loop); the unfused loop reads the same mask, so the
    # two paths see identical stall sets
    if stall_rounds_set:
        b_max = max(engine._slots)
        stall_mask = np.zeros((max(stall_rounds_set) + 1,
                               len(engine.engines), b_max), bool)
        for r in stall_rounds_set:
            for g, b in enumerate(engine._slots):
                stall_mask[r, g, :b] = True
        engine.stall_fn = stall_mask
    else:
        engine.stall_fn = None
    try:
        report = engine.run(fail_at=fail_at, fused=fused)
    finally:
        engine.stall_fn = old_stall
    serve = report.extras["serve"]
    check(serve["drained"], "serve plane failed to drain the schedule")
    check(serve["fail_at_unreached"] == sorted(
        r for r in fail_at if r >= serve["engine_rounds"]),
        "unreached fail_at rounds mis-surfaced")

    alive = set(range(engine.domain.n_nodes)) - set(killed)
    epochs: List[Tuple[Dict[str, Any], Optional[Any]]] = [
        (old_logs, old_report) for (_, _, old_report, old_logs)
        in engine.view_log]
    epochs.append((report.extras["delivery_logs"], None))
    epoch_digests: List[Any] = []
    for e, (logs, old_report) in enumerate(epochs):
        digest = []
        for g, topic in enumerate(engine.topics):
            if topic.name not in logs:
                continue
            log = logs[topic.name]
            # never-killed subscribers survived EVERY epoch, so they
            # must agree on each epoch's log (subscribers that died in
            # a later epoch also held this one's; checking the common
            # survivors is the everywhere-or-nowhere core)
            surv = [s for s in topic.subscribers if s in alive]
            if not surv:
                continue
            seqs = [log.sequence(s) for s in surv]
            for s in seqs[1:]:
                check(s == seqs[0],
                      "surviving subscribers disagree on an epoch log",
                      e, topic.name)
            per_rank = _fifo_apps(log, surv[0])
            check.n += 1
            if old_report is not None:
                stable = old_report.extras["view_change"][
                    "stable_apps_by_old_rank"][g]
                for rank, cnt in enumerate(stable):
                    check(per_rank.get(rank, 0) == int(cnt),
                          "epoch delivered more or less than its "
                          "stable prefix", e, topic.name, rank,
                          per_rank.get(rank, 0), int(cnt))
            digest.append((topic.name, tuple(seqs[0])))
        epoch_digests.append(tuple(digest))

    completed_rids = {r.rid for eng in engine.engines
                      for r in eng.completed}
    shed_rids = {rid for rid, _ in engine.shed_log}
    check(completed_rids.isdisjoint(shed_rids),
          "a request both completed and shed", completed_rids & shed_rids)
    check(completed_rids | shed_rids == set(submitted),
          "completed + shed do not partition the submitted work",
          sorted(set(submitted) - completed_rids - shed_rids))
    for rec in engine.slot_failures:
        check(rec["lost_apps"] >= 0,
              "dead slot delivered more apps than it enqueued", rec)
    return ChaosReport(
        target="serve", seed=seed, backend=engine.backend,
        rounds=serve["engine_rounds"],
        views_installed=serve["view_changes"],
        wedge_retries=engine._ms.wedge_retries,
        killed=tuple(killed), joined=(),
        stall_rounds=serve["stall_rounds"], checks=check.n,
        extras={
            "epoch_digests": epoch_digests,
            "completed_tokens": {
                g: [tuple(t) for t in toks]
                for g, toks in engine.completed().items()},
            "slot_failures": serve["slot_failures"],
            "voided": serve["voided_requests"],
            "requeued": serve["requeued_requests"],
            "shed": sorted(shed_rids),
            "fail_at_unreached": serve["fail_at_unreached"],
            "fused": serve.get("fused", False),
            "fused_fallback": serve.get("fused_fallback"),
        })


# ---------------------------------------------------------------------------
# gradsync soak
# ---------------------------------------------------------------------------

def _soak_gradsync(gs, spec: FaultSpec, seed: int) -> ChaosReport:
    rng = np.random.default_rng(seed)
    check = _Checker(seed)
    members0 = gs.members
    reporter = members0[0]
    killable = list(members0[1:])
    joinable = [max(members0) + 1 + i for i in range(2)]
    schedule = spec.sample(rng, killable=killable, joinable=joinable)
    by_round = events_by_round(schedule)

    ms = views_mod.MembershipService(members0)
    killed: List[int] = []
    joined: List[int] = []
    stall_left = 0
    stall_rounds = 0
    contributors_by_step: Dict[int, set] = {}
    prev_base: Dict[int, int] = {}
    n_rounds = 0
    for rnd in range(spec.rounds):
        live = [m for m in gs.members if m not in killed]
        if stall_left > 0:
            stall_left -= 1
            stall_rounds += 1
            gs.contribute({})                      # pure drain round
        else:
            step = gs._next_step
            contribs = {m: {"w": float(rng.normal())} for m in live}
            contributors_by_step[step] = set(contribs)
            gs.contribute(contribs)
            n_rounds += 1
        evs = by_round.get(rnd, ())
        waves: List[List[int]] = []
        dirty = False
        for ev in evs:
            if ev.kind == "stall":
                stall_left = max(stall_left, ev.length)
            elif ev.kind == "join":
                for n in ev.nodes:
                    ms.request_join(n)
                    joined.append(n)
                dirty = True
            elif ev.kind in ("suspect", "slot_kill"):
                waves.extend(_waves_of(ev))
                dirty = True
        if not dirty:
            continue
        for w in waves:
            killed.extend(w)
        if waves:
            for n in waves[0]:
                ms.suspect(reporter, n)

        def _during_wedge(svc, attempt, _waves=waves):
            nxt = attempt + 1
            if nxt < len(_waves):
                for n in _waves[nxt]:
                    svc.suspect(reporter, n)

        applied_before = gs.applied_step
        _view, gs = ms.reconfigure_stream(
            gs, {},
            during_wedge=_during_wedge if len(waves) > 1 else None)
        check(gs.applied_step >= applied_before,
              "applied watermark rolled back across the cut", rnd)
        for node, base in gs._base.items():
            check(base >= prev_base.get(node, 0),
                  "per-node stable base rolled back", rnd, node)
            prev_base[node] = base
    gs.finish()
    steps = [a.step for a in gs.applied]
    check(steps == sorted(set(steps)),
          "rounds applied out of order or twice", steps)
    check(steps == list(range(len(steps))),
          "an optimizer round was skipped", steps)
    check(len(steps) == n_rounds,
          "not every contributed round applied", len(steps), n_rounds)
    for a in gs.applied:
        check(set(a.contributors) | set(a.voided)
              == contributors_by_step[a.step],
              "an applied round gained or lost contributors", a.step)
        check(set(a.voided) <= set(killed),
              "a LIVE contributor was voided", a.step, a.voided)
        check(not (set(a.contributors) & set(a.voided)),
              "a contributor both applied and voided", a.step)
    return ChaosReport(
        target="gradsync", seed=seed, backend=gs.backend,
        rounds=spec.rounds, views_installed=len(ms.history) - 1,
        wedge_retries=ms.wedge_retries, killed=tuple(killed),
        joined=tuple(joined), stall_rounds=stall_rounds, checks=check.n,
        extras={
            "applied": [(a.step, a.contributors, a.voided)
                        for a in gs.applied],
            "updates": [round(float(a.update["w"]), 12)
                        if a.update is not None else None
                        for a in gs.applied],
        })


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def chaos_soak(target, spec: FaultSpec, *, seed: int = 0,
               backend: str = "kernel",
               fused: bool = False) -> ChaosReport:
    """Run ``target`` through one seeded fault schedule drawn from
    ``spec`` and assert the plane's invariants after every installed
    view (module docstring lists them per target kind).  ``backend``
    selects the substrate when the soak builds the stream itself (a
    ``Group`` target, on the Group's device); targets that already carry
    a backend (``GroupStream`` / ``ReplicatedEngine`` /
    ``BucketSyncStream``) use their own.  Deterministic: same target
    shape + spec + seed => same schedule, same report, on every backend
    and device that is bit-identical (``graph`` and ``kernel``, the card
    and the CPU).

    ``fused=True`` (serve targets only) asks the run for the
    wedge-capable fused path: schedules whose cuts stay homogeneous run
    as one device program per membership epoch; heterogeneous draws
    fall back to the per-round loop with the reason recorded — either
    way the report is bit-identical, and
    ``extras['fused']``/``extras['fused_fallback']`` say which path
    actually ran.  ``backend="des"`` is not ported yet: it raises the
    ``ValueError`` of :func:`repro_torch.core.group.get_backend`, which
    names item 13."""
    if isinstance(target, BucketSyncStream):
        return _soak_gradsync(target, spec, seed)
    if isinstance(target, (group_mod.Group, group_mod.GroupStream)):
        return _soak_stream(target, spec, seed, backend)
    # by name: the serve plane pulls in the model zoo
    cls = type(target).__name__
    if cls == "ReplicatedEngine":
        return _soak_serve(target, spec, seed, fused=fused)
    raise TypeError(
        f"chaos_soak does not know how to drive a {cls}: expected a "
        "Group, GroupStream, ReplicatedEngine, or BucketSyncStream")
