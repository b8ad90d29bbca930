"""The port's membership service (``repro_torch.core.views``) against the
reference's (``repro.core.views``).

Both state machines are driven by the same seeded schedules of
suspicions, joins and cascading waves (suspicions that land while the
wedge is open); the view histories, ``stale_suspicions``,
``wedge_retries``, restart watermarks and errors must be identical.
The errors are ``TotalFailureError`` (no survivor), ``WedgeAborted``
(a cascade past ``max_wedge_retries``) and ``ValueError`` (a suspicion
of a node that was never a member).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import views as ref_views
from repro_torch.core import views as port_views

pytestmark = pytest.mark.fast

PACKAGES = (("port", port_views), ("ref", ref_views))


def _view(v):
    return dataclasses.astuple(v)


def _state(ms):
    return ([_view(v) for v in ms.history], list(ms.stale_suspicions),
            ms.wedge_retries, list(ms.pending_joins), ms.needs_change())


def _outcome(fn):
    """(kind, value): a returned view, or the error's type name and
    message."""
    try:
        return "ok", fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)


def _drive(views, seed, n0, n_events, max_retries):
    """One seeded schedule: suspicions (some of never-members, some of
    already-removed nodes), joins, cancelled joins and cascades; returns
    every outcome and the final state."""
    rng = np.random.default_rng(seed)
    ms = views.MembershipService(range(n0))
    out = []
    next_joiner = 100
    for _ in range(n_events):
        kind = int(rng.integers(0, 5))
        members = ms.view.members
        if kind == 0:                            # a suspicion
            node = int(rng.choice(list(members) + [next_joiner + 50]))
            out.append(_outcome(lambda: ms.suspect(members[0], node)))
        elif kind == 1:                          # a join
            out.append(_outcome(lambda: ms.request_join(next_joiner)))
            next_joiner += int(rng.integers(1, 3))
        elif kind == 2 and ms.pending_joins:     # a joiner dies first
            j = ms.pending_joins[int(rng.integers(len(ms.pending_joins)))]
            out.append(_outcome(lambda: ms.suspect(members[0], j)))
        else:                                    # a view change
            waves = [[int(x)] for x in rng.choice(
                members, size=min(len(members), int(rng.integers(0, 4))),
                replace=False)]

            def during(svc, attempt, waves=waves):
                if attempt < len(waves):
                    for n in waves[attempt]:
                        svc.suspect(svc.view.members[0], n)

            committed = {m: int(rng.integers(0, 20)) for m in members}
            out.append(_outcome(lambda: _view(ms.propose_and_install(
                committed, during_wedge=during if waves else None,
                max_wedge_retries=max_retries))))
            out.append(_outcome(ms.restart_watermark))
        out.append(_state(ms))
    return out


@pytest.mark.parametrize("seed", [3, 11, 23, 47, 101])
@pytest.mark.parametrize("max_retries", [1, 8])
def test_seeded_schedules_give_the_reference_histories(seed, max_retries):
    port = _drive(port_views, seed, 6, 30, max_retries)
    ref = _drive(ref_views, seed, 6, 30, max_retries)
    assert port == ref


def test_joiner_rank_is_arrival_order_independent():
    for _, views in PACKAGES:
        a = views.MembershipService([0, 1, 2, 3])
        b = views.MembershipService([0, 1, 2, 3])
        for j in (7, 5, 9):
            a.request_join(j)
        for j in (9, 7, 5):
            b.request_join(j)
        a.suspect(0, 2)
        b.suspect(1, 2)
        va = a.propose_and_install({m: 1 for m in range(4)})
        vb = b.propose_and_install({m: 1 for m in range(4)})
        assert va == vb and va.joiners == (5, 7, 9)
        assert [va.rank(n) for n in va.members] == \
            [vb.rank(n) for n in vb.members]


def test_suspicions_of_removed_and_unknown_nodes():
    outs = []
    for _, views in PACKAGES:
        ms = views.MembershipService([0, 1, 2, 3])
        ms.suspect(0, 3)
        ms.propose_and_install({})
        ms.suspect(1, 3)                    # raced the install: recorded
        assert not ms.needs_change()
        with pytest.raises(ValueError, match="never a member"):
            ms.suspect(0, 99)
        outs.append(_state(ms))
    assert outs[0] == outs[1]


def test_cascade_folds_into_one_view():
    outs = []
    for _, views in PACKAGES:
        ms = views.MembershipService([0, 1, 2, 3, 4, 5])

        def wedge(svc, attempt):
            if attempt == 0:
                svc.suspect(0, 4)

        ms.suspect(0, 5)
        v = ms.propose_and_install({}, during_wedge=wedge)
        assert v.vid == 1 and set(v.members) == {0, 1, 2, 3}
        assert ms.wedge_retries == 1
        outs.append(_state(ms))
    assert outs[0] == outs[1]


def test_wedge_aborted_and_total_failure():
    errors = []
    for _, views in PACKAGES:
        ms = views.MembershipService(range(12))
        ms.suspect(0, 11)

        def endless(svc, attempt):
            svc.suspect(0, 10 - attempt)

        with pytest.raises(views.WedgeAborted,
                           match="max_wedge_retries") as e1:
            ms.propose_and_install({}, during_wedge=endless,
                                   max_wedge_retries=3)
        ms2 = views.MembershipService([0, 1])
        ms2.suspect(0, 0)
        ms2.suspect(0, 1)
        with pytest.raises(views.TotalFailureError) as e2:
            ms2.propose_and_install({})
        errors.append((str(e1.value), str(e2.value), _state(ms)))
    assert errors[0] == errors[1]


def test_restart_watermark_and_reconfigure_without_change():
    outs = []
    for _, views in PACKAGES:
        ms = views.MembershipService([0, 1, 2], senders=[0, 1])
        assert ms.view.senders == (0, 1)
        assert ms.reconfigure("group", {}) == (ms.view, "group")
        assert ms.reconfigure_stream("stream", {}) == (ms.view, "stream")
        ms.request_join(4)
        ms.propose_and_install({0: 5, 1: 7, 2: 6})
        outs.append((ms.restart_watermark(), _state(ms)))
    assert outs[0] == outs[1] and outs[0][0] == 5
