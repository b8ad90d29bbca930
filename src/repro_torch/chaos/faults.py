"""Seeded fault schedules: the sampling half of the chaos plane.

A :class:`FaultSpec` is a distribution over *fault schedules* — per-round
suspicions (with optional cascades that land DURING the wedge), joins,
slot-node kills, and load-plane stall bursts — and :meth:`FaultSpec.sample`
draws one concrete, fully deterministic schedule from a caller-provided
``numpy`` generator.  The same seed always yields the same schedule, so a
chaos soak is a reproducible test case, not a flake: CI pins a seed
matrix (the ``chaos-soak`` job) and a failure replays locally with
nothing but the seed.

The sampler enforces the structural survivability constraints the
drivers require — it never kills a protected node, never schedules a
replica's LAST live slot node, and respects ``max_kills`` — so every
sampled schedule is survivable by construction; what the soak then
checks is that the *protocol* survives it (exactly-once, FIFO, monotone
``app_base`` — :mod:`repro_torch.chaos.soak`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``kind`` is one of:

    * ``"suspect"`` — ``nodes`` fail after round ``round``'s dispatch;
      ``cascade`` holds later waves whose suspicions land while the
      wedge for ``nodes`` is in progress (folded into the SAME cut).
    * ``"join"`` — ``nodes`` request to join at round ``round`` (they
      ride the next installed view).
    * ``"slot_kill"`` — ``nodes`` are slot (publisher) nodes of a serve
      replica; same failure semantics as ``suspect`` but sampled under
      the keep-one-slot-per-replica constraint.
    * ``"stall"`` — a load-plane stall burst: for ``length`` rounds
      starting at ``round`` the affected senders are backpressured
      (publish nothing / decode null rounds).
    """

    round: int
    kind: str
    nodes: Tuple[int, ...] = ()
    cascade: Tuple[Tuple[int, ...], ...] = ()
    length: int = 0


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-round fault rates; ``sample`` draws a deterministic schedule.

    ``suspect_rate``/``join_rate``/``slot_kill_rate``/``stall_rate`` are
    per-round Bernoulli probabilities; ``cascade_prob`` is the chance a
    suspicion brings a second wave mid-wedge (applied recursively, so
    deeper cascades are geometrically rarer); ``stall_len`` bounds a
    stall burst's length (inclusive).  ``max_kills`` caps total nodes
    killed across suspicions and slot kills (None = only the structural
    constraints cap it).
    """

    rounds: int = 24
    suspect_rate: float = 0.08
    cascade_prob: float = 0.35
    join_rate: float = 0.05
    slot_kill_rate: float = 0.0
    stall_rate: float = 0.08
    stall_len: Tuple[int, int] = (1, 3)
    max_kills: Optional[int] = None

    def sample(self, rng: np.random.Generator, *,
               killable: Sequence[int] = (),
               joinable: Sequence[int] = (),
               slot_groups: Sequence[Sequence[int]] = (),
               ) -> List[FaultEvent]:
        """Draw one schedule.

        ``killable`` — nodes that may be suspected (the driver excludes
        the nodes whose survival its invariant checks require, e.g. one
        member+sender per subgroup or one subscriber per topic);
        ``joinable`` — nodes that may request a join; ``slot_groups`` —
        per-replica slot-node lists (a kill is only drawn while the
        group keeps >= 2 live slots, so no replica ever loses its last
        publisher lane).  Events are returned in round order; at most
        one event of each kind per round.
        """
        killable = list(dict.fromkeys(killable))
        joinable = list(dict.fromkeys(joinable))
        groups = [list(g) for g in slot_groups]
        kills_left = (self.max_kills if self.max_kills is not None
                      else len(killable) + sum(map(len, groups)))
        events: List[FaultEvent] = []
        for rnd in range(self.rounds):
            if (killable and kills_left > 0
                    and rng.random() < self.suspect_rate):
                waves = []
                while (killable and kills_left > 0
                       and len(waves) < 1 + 3):   # primary + <=3 cascades
                    victim = killable.pop(
                        int(rng.integers(len(killable))))
                    waves.append((victim,))
                    kills_left -= 1
                    if rng.random() >= self.cascade_prob:
                        break
                events.append(FaultEvent(
                    round=rnd, kind="suspect", nodes=waves[0],
                    cascade=tuple(waves[1:])))
            live_groups = [i for i, g in enumerate(groups) if len(g) > 1]
            if (live_groups and kills_left > 0
                    and rng.random() < self.slot_kill_rate):
                gi = live_groups[int(rng.integers(len(live_groups)))]
                victim = groups[gi].pop(
                    int(rng.integers(len(groups[gi]))))
                kills_left -= 1
                events.append(FaultEvent(round=rnd, kind="slot_kill",
                                         nodes=(victim,)))
            if joinable and rng.random() < self.join_rate:
                node = joinable.pop(int(rng.integers(len(joinable))))
                events.append(FaultEvent(round=rnd, kind="join",
                                         nodes=(node,)))
            if self.stall_rate and rng.random() < self.stall_rate:
                lo, hi = self.stall_len
                events.append(FaultEvent(
                    round=rnd, kind="stall",
                    length=int(rng.integers(lo, hi + 1))))
        return events


def events_by_round(events: Sequence[FaultEvent]
                    ) -> Dict[int, List[FaultEvent]]:
    out: Dict[int, List[FaultEvent]] = {}
    for ev in events:
        out.setdefault(ev.round, []).append(ev)
    return out
