"""Virtual-synchrony views (paper Secs. 2.1, 3.3) adapted to elastic
training membership.

Derecho evolves a top-level group through a sequence of *views* using
partition-free state-machine replication: each view has a fixed, ordered
membership; failures/joins/leaves trigger a view change; messages underway
at a view change are either delivered everywhere or nowhere and resent in
the next view.

Training adaptation: a view == a training *epoch of membership*.  The
members are worker hosts, the round-robin "senders" are the data-parallel
participants, and the cleanup guarantee becomes: an optimizer step is
either applied by every worker or rolled back to the checkpoint watermark
(``delivered_step`` in :class:`repro_torch.core.gradsync.SyncState`).

The protocol below is the standard monotone two-phase install driven
through SST-style state: every row only ever increases, so acknowledgments
coalesce and stale reads are harmless — which is precisely why it composes
with the Spindle optimizations.

The wedge/ragged-trim half of virtual synchrony — what happens to
messages *underway* at the view change — lives where the in-flight state
lives: :meth:`repro_torch.core.group.GroupStream.reconfigure` computes
the cut from the stream's SST watermarks
(:func:`repro_torch.core.sst.ragged_trim`) and carries the resend
counts into the next view; :meth:`MembershipService.reconfigure_stream`
drives that end-to-end (DESIGN.md Sec. 7).  This module is plain Python,
the same as the reference package's ``core/views.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class TotalFailureError(RuntimeError):
    """Every member of the current view is suspected.

    There is no survivor set to wedge, so no cut exists: the caller must
    restart from a checkpoint (train plane) or cold-start the domain
    (serve plane).  Raised instead of installing an empty view so the
    failure is explicit rather than a downstream shape error.
    """


class WedgeAborted(RuntimeError):
    """Cascading suspicions kept re-entering the wedge past the retry
    bound (``max_wedge_retries``): every attempt to agree on a survivor
    set was invalidated by a new suspicion before install.  On a real
    cluster this is the pathological churn case where the membership
    service cannot stabilize; surfacing it beats spinning forever.
    """


@dataclasses.dataclass(frozen=True)
class View:
    """One membership epoch."""

    vid: int
    members: Tuple[int, ...]           # ordered — defines delivery ranks
    senders: Tuple[int, ...]           # active data-parallel participants
    joiners: Tuple[int, ...] = ()      # members new in this view

    def __post_init__(self):
        assert tuple(sorted(set(self.members))) == tuple(sorted(self.members))
        assert set(self.senders) <= set(self.members)

    @property
    def leader(self) -> int:
        return self.members[0]

    def rank(self, node: int) -> int:
        return self.members.index(node)


@dataclasses.dataclass
class _NodeRow:
    """SST row for membership: all fields are monotone."""

    suspected: set = dataclasses.field(default_factory=set)  # grows only
    proposed_vid: int = 0        # highest view id this node has proposed/acked
    wedged_vid: int = -1         # highest view this node stopped sending in
    installed_vid: int = 0
    committed_step: int = 0      # checkpoint watermark at wedge time


class MembershipService:
    """A deterministic, in-process view-change engine.

    On a real cluster this state machine runs over the distributed SST
    (every mutation below is a monotone own-row update + push); here the
    rows live in one address space so the trainer and tests can drive
    failures, joins and elastic resizes deterministically.
    """

    def __init__(self, initial_members: Sequence[int],
                 senders: Optional[Sequence[int]] = None):
        members = tuple(sorted(initial_members))
        self.view = View(vid=0, members=members,
                         senders=tuple(senders) if senders else members)
        self.rows: Dict[int, _NodeRow] = {m: _NodeRow() for m in members}
        self.history: List[View] = [self.view]
        self.pending_joins: List[int] = []
        # Nodes that were a member of SOME past view (for distinguishing a
        # benign stale suspicion from a reporter bug), plus a log of the
        # stale reports so chaos schedules that race a kill against an
        # install can verify no report was silently dropped.
        self._ever_members: set = set(members)
        self.stale_suspicions: List[Tuple[int, int, int]] = []  # (reporter, failed, vid)
        self.wedge_retries: int = 0   # total re-entered wedges (diagnostics)

    # -- failure detection -------------------------------------------------

    def suspect(self, reporter: int, failed: int):
        """A heartbeat watermark stopped advancing: report a suspicion.
        Suspicions are monotone (never retracted within a view).

        A suspicion of a node that was *already removed* by an earlier
        install is an idempotent no-op — the report simply raced the
        install — but it is recorded in :attr:`stale_suspicions` so fault
        schedules can assert nothing was lost.  A suspicion of a node
        that was NEVER a member of any view is a reporter bug (a wild
        pointer into the membership space), not a benign race: raise.
        """
        if failed in self.view.members:
            self.rows[reporter].suspected.add(failed)
            return
        if failed in self.pending_joins:
            # The joiner died before its view installed: cancel the join
            # (it never carried state, so nothing to cut) and record it.
            self.pending_joins.remove(failed)
            self.stale_suspicions.append((reporter, failed, self.view.vid))
            return
        if failed in self._ever_members:
            self.stale_suspicions.append((reporter, failed, self.view.vid))
            return
        raise ValueError(
            f"suspect({reporter} -> {failed}): node {failed} was never a "
            "member of any view — a suspicion of an unknown node is a "
            "reporter bug, not a report racing an install")

    def request_join(self, node: int):
        if node not in self.view.members and node not in self.pending_joins:
            self.pending_joins.append(node)
            # Joiner order (and hence the new view's rank assignment) must
            # not depend on request arrival order — different nodes observe
            # joins in different orders, and a dict/arrival-ordered list
            # here would give them different views.  Keep the pending list
            # canonically sorted so every replica of this state machine
            # installs the identical View.
            self.pending_joins.sort()

    # -- the two-phase monotone view change ---------------------------------

    def _survivors(self) -> Tuple[int, ...]:
        all_susp = set()
        for m in self.view.members:
            all_susp |= self.rows[m].suspected
        return tuple(m for m in self.view.members if m not in all_susp)

    def needs_change(self) -> bool:
        return bool(self._survivors() != self.view.members
                    or self.pending_joins)

    def propose_and_install(
            self, committed_steps: Dict[int, int], *,
            during_wedge: Optional[Callable[["MembershipService", int], None]] = None,
            max_wedge_retries: int = 8) -> View:
        """Run a full view change: wedge -> agree on watermark -> install.

        committed_steps[node] = that node's delivered_step watermark.  The
        new view's members resume from min over survivors — the virtual
        synchrony cleanup: steps beyond the watermark are either already
        applied everywhere or discarded and redone.

        **Cascading suspicions.**  On a real cluster new ``suspect()``
        reports can land while the wedge is in progress (a second node
        times out exactly because the first failure stalled it).
        ``during_wedge(service, attempt)`` is the deterministic stand-in
        for that concurrency: it is invoked after each wedge attempt and
        may call :meth:`suspect` / :meth:`request_join`.  If the survivor
        set shrank, the install is NOT performed — the late suspicions
        are *folded into the pending cut* and the wedge re-enters with
        the smaller survivor set.  Exactly one view is installed for the
        whole cascade (one ``vid`` consumed, one cut computed over the
        final survivors), never a doomed intermediate view.  Folding is
        safe for the stream cut because removing a node from the
        min-over-survivors can only RAISE the stable frontier
        (:func:`repro_torch.core.sst.cascading_trim`): no watermark ever rolls
        back.  After ``max_wedge_retries`` re-entries the change aborts
        with :class:`WedgeAborted`; an empty survivor set at any attempt
        raises :class:`TotalFailureError`.
        """
        if not self.needs_change():
            return self.view
        next_vid = self.view.vid + 1
        attempt = 0
        while True:
            survivors = self._survivors()
            if not survivors:
                raise TotalFailureError("total failure: no survivors")
            # Phase 1: wedge — survivors stop sending in the old view and
            # publish their watermark (monotone row updates).
            for m in survivors:
                row = self.rows[m]
                row.wedged_vid = max(row.wedged_vid, self.view.vid)
                row.proposed_vid = max(row.proposed_vid, next_vid)
                row.committed_step = max(row.committed_step,
                                         committed_steps.get(m, 0))
            # Late suspicions landing while the wedge is in progress fold
            # into THIS pending change instead of installing a doomed
            # intermediate view.
            if during_wedge is not None:
                during_wedge(self, attempt)
                if self._survivors() != survivors:
                    attempt += 1
                    self.wedge_retries += 1
                    if attempt > max_wedge_retries:
                        raise WedgeAborted(
                            f"view change v{self.view.vid}->v{next_vid} "
                            f"re-entered the wedge {attempt} times "
                            f"(max_wedge_retries={max_wedge_retries}): "
                            "suspicions are arriving faster than the wedge "
                            "can stabilize")
                    continue
            # Phase 2: the surviving leader installs once every survivor has
            # acked (proposed_vid reached next_vid) — trivially true here, on
            # a cluster this is the poll of the proposed_vid column.
            assert all(self.rows[m].proposed_vid >= next_vid
                       for m in survivors)
            joiners = tuple(self.pending_joins)
            members = tuple(sorted(set(survivors) | set(joiners)))
            self.pending_joins = []
            new_view = View(vid=next_vid, members=members, senders=members,
                            joiners=joiners)
            for j in joiners:
                self.rows[j] = _NodeRow()
            for m in members:
                self.rows[m].installed_vid = next_vid
                self.rows[m].suspected = set()
            self._ever_members |= set(members)
            self.view = new_view
            self.history.append(new_view)
            return new_view

    def restart_watermark(self) -> int:
        """The step every member of the current view resumes from."""
        old = set(self.history[-2].members) if len(self.history) > 1 else set()
        carriers = [m for m in self.view.members if m in old] or \
            list(self.view.members)
        return min(self.rows[m].committed_step for m in carriers)

    # -- Group-API integration ----------------------------------------------

    def reconfigure(self, group, committed_steps: Dict[int, int], **wedge_kw):
        """Drive one view change end-to-end against a
        :class:`repro_torch.core.group.Group`: run the two-phase install,
        then restrict every subgroup of ``group`` to the new membership.

        Returns ``(view, new_group)``; ``new_group is group`` when no
        change was pending.  This is the seam the elastic runtime uses —
        suspicions/joins accumulate here, the multicast sessions re-form
        through the Group façade.  ``wedge_kw`` (``during_wedge``,
        ``max_wedge_retries``) forwards to :meth:`propose_and_install`.
        """
        if not self.needs_change():
            return self.view, group
        view = self.propose_and_install(committed_steps, **wedge_kw)
        return view, group.reconfigure(view)

    def reconfigure_stream(self, stream, committed_steps: Dict[int, int],
                           **wedge_kw):
        """Drive one view change against a LIVE
        :class:`repro_torch.core.group.GroupStream`: wedge (two-phase
        install), then hand the stream's in-flight state across the
        virtual-synchrony cut (DESIGN.md Sec. 7).

        Where :meth:`reconfigure` rebuilds a scheduled :class:`Group`
        from scratch, this is the failure path the paper's robustness
        claims rest on — messages underway at the view change are
        delivered everywhere-or-nowhere at the ragged trim
        (:func:`repro_torch.core.sst.ragged_trim` over the stream's SST
        watermarks) and the undelivered remainder is resent by the
        surviving senders in the new view (the new stream starts with
        those resend counts as its backlog).

        Suspicions that land during the wedge (``during_wedge`` in
        ``wedge_kw``) fold into this single cut: the stream's trim is
        computed once, over the FINAL survivor set, after the wedge
        stabilizes — and since shrinking the survivor set can only raise
        the min-over-survivors frontier, folding never rolls a delivery
        watermark back (:func:`repro_torch.core.sst.cascading_trim`).

        Returns ``(view, new_stream)``; ``new_stream is stream`` when no
        change was pending.  The old stream is closed: its epoch's
        delivery logs (cut-clipped) and report are installed on its
        owning Group exactly as ``finish()`` would.
        """
        if not self.needs_change():
            return self.view, stream
        view = self.propose_and_install(committed_steps, **wedge_kw)
        return view, stream.reconfigure(view)
