"""Staged load profiles: warmup -> step loads -> overload
(DESIGN.md Sec. 10).

A :class:`Profile` is an arrival generator plus an ordered list of
:class:`Stage`\\ s, each scaling the generator's base rate for a number
of rounds — the k6/locust "ramping arrival rate" executor shape, in
protocol rounds instead of wall seconds.  The profile owns the seed:
``matrices(shape)`` threads ONE seeded generator through the stages in
order, so the same (seed, stages, generator) triple yields bit-identical
arrival matrices everywhere — the determinism the conformance tests and
the loadtest benchmark gates rely on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.load.arrivals import ArrivalSpec


@dataclasses.dataclass(frozen=True)
class Stage:
    """One constant-scale segment of a profile."""

    name: str
    rounds: int
    scale: float = 1.0

    def __post_init__(self):
        if self.rounds <= 0:
            raise ValueError(f"stage {self.name!r} needs rounds >= 1")
        if self.scale < 0:
            raise ValueError(f"stage {self.name!r} has negative scale")


@dataclasses.dataclass(frozen=True)
class Profile:
    """An arrival generator swept through staged rate scales."""

    arrivals: ArrivalSpec
    stages: Tuple[Stage, ...]
    seed: int = 0

    def __post_init__(self):
        if not self.stages:
            raise ValueError("profile needs at least one stage")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")

    @property
    def total_rounds(self) -> int:
        return sum(s.rounds for s in self.stages)

    def stage_bounds(self) -> List[Tuple[int, int]]:
        """Per stage: ``[start_round, end_round)`` in global rounds."""
        bounds, t = [], 0
        for s in self.stages:
            bounds.append((t, t + s.rounds))
            t += s.rounds
        return bounds

    def matrices(self, shape: Tuple[int, int],
                 sender_mask: Optional[np.ndarray] = None
                 ) -> List[np.ndarray]:
        """Sample every stage's ``(rounds, G, S)`` arrival matrix from
        one seeded generator, in stage order.  ``sender_mask`` (G, S)
        zeroes padded sender lanes AFTER sampling, so the drawn random
        stream — and hence every real lane's arrivals — is independent
        of how much padding the target's stacked shape happens to
        carry."""
        rng = np.random.default_rng(self.seed)
        out, t = [], 0
        for s in self.stages:
            m = self.arrivals.sample(s.rounds, shape, s.scale, rng,
                                     start=t)
            if sender_mask is not None:
                m = np.where(sender_mask[None, :, :], m, 0)
            out.append(m)
            t += s.rounds
        return out


def staged_ramp(arrivals: ArrivalSpec, *, warmup: int = 20,
                warmup_scale: float = 0.25,
                steps: Sequence[float] = (0.5, 1.0),
                rounds_per_stage: int = 40,
                overload: float = 4.0,
                overload_rounds: Optional[int] = None,
                seed: int = 0) -> Profile:
    """The canonical open-loop sweep: a low-rate warmup (compile + cache
    fill), ascending step loads, then one stage deliberately past
    saturation.  The overload stage is not optional — a load test that
    never saturates cannot distinguish goodput from offered load
    (DESIGN.md Sec. 10)."""
    stages = [Stage("warmup", warmup, warmup_scale)]
    stages += [Stage(f"step-{s:g}", rounds_per_stage, s) for s in steps]
    stages.append(Stage("overload", overload_rounds or rounds_per_stage,
                        overload))
    return Profile(arrivals=arrivals, stages=tuple(stages), seed=seed)
