"""Seeded open-loop arrival generators (DESIGN.md Sec. 10).

Each generator produces a ``(T, G, S)`` integer matrix of per-round,
per-subgroup, per-sender message arrivals — the open-loop offered load.
Open-loop means the matrix is a function of the clock only: arrivals do
NOT slow down when the protocol falls behind (that feedback, if any, is
the admission policy's job — :mod:`repro_torch.load.admission`).  The closed-
loop scenarios elsewhere in this repo (fixed per-sender budgets lowered
upfront) answer "how fast can the protocol go"; these answer "what does
it do when traffic doesn't wait" — Spindle's robustness-to-delay claim
is only testable this way.

Determinism contract: every generator draws exclusively from the
``numpy.random.Generator`` passed in, in a fixed order, so one seeded
generator threaded through a profile's stages yields bit-identical
matrices on every run, platform, and backend.  ``start`` carries the
global round offset so phase-dependent generators (diurnal, traces)
continue seamlessly across stage boundaries.

The matrix form is also what makes the FUSED load and serve paths
possible (DESIGN.md Sec. 6): because the offered load is a precomputed
host array rather than a per-round callback, the whole profile can ride
into one compiled device program as a scan operand — the harness's
``fused=True`` and the serve plane's ``arrive_schedule`` both lean on
exactly this property, and it is why arbitrary ``arrive_fn`` callables
are the one arrival form that still forces the per-round host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


class ArrivalSpec:
    """Protocol for arrival generators: ``sample(rounds, shape, scale,
    rng, start=0) -> (rounds,) + shape int64`` arrival counts.  ``scale``
    is the stage's load multiplier (profiles ramp it); ``start`` the
    global round index of the first sampled round."""

    def sample(self, rounds: int, shape: Tuple[int, int], scale: float,
               rng: np.random.Generator, start: int = 0) -> np.ndarray:
        raise NotImplementedError


def _lam(rate, shape, scale: float) -> np.ndarray:
    """Broadcast a scalar or per-(g, s) rate to ``shape``, scaled."""
    lam = np.broadcast_to(np.asarray(rate, np.float64), shape) * scale
    if (lam < 0).any():
        raise ValueError("arrival rates must be >= 0")
    return lam


@dataclasses.dataclass(frozen=True)
class Poisson(ArrivalSpec):
    """Memoryless arrivals: each sender independently receives
    ``Poisson(rate * scale)`` messages per round.  ``rate`` may be a
    scalar or anything broadcastable to ``(G, S)`` for heterogeneous
    per-client rates."""

    rate: object = 1.0

    def sample(self, rounds, shape, scale, rng, start=0):
        lam = _lam(self.rate, shape, scale)
        return rng.poisson(lam, size=(rounds,) + tuple(shape)).astype(
            np.int64)


@dataclasses.dataclass(frozen=True)
class OnOff(ArrivalSpec):
    """Bursty MMPP-style arrivals: each sender is an independent two-state
    Markov chain (ON at ``rate_on``, OFF at ``rate_off``), flipping with
    per-round probabilities ``p_on_off`` / ``p_off_on``.  Starts from the
    chain's stationary distribution so the first round is not special."""

    rate_on: float = 2.0
    rate_off: float = 0.0
    p_on_off: float = 0.1
    p_off_on: float = 0.1

    def sample(self, rounds, shape, scale, rng, start=0):
        if not (0 <= self.p_on_off <= 1 and 0 <= self.p_off_on <= 1):
            raise ValueError("flip probabilities must be in [0, 1]")
        p_on = self.p_off_on / max(self.p_on_off + self.p_off_on, 1e-12)
        on = rng.random(shape) < p_on
        out = np.zeros((rounds,) + tuple(shape), np.int64)
        for t in range(rounds):
            lam = np.where(on, self.rate_on, self.rate_off) * scale
            out[t] = rng.poisson(np.maximum(lam, 0.0))
            flip = rng.random(shape)
            on = np.where(on, flip >= self.p_on_off, flip < self.p_off_on)
        return out


@dataclasses.dataclass(frozen=True)
class Diurnal(ArrivalSpec):
    """Sinusoidally modulated Poisson arrivals — the day/night envelope:
    rate ``rate * scale * (1 + amplitude * sin(2*pi*(t + phase)/period))``
    clipped at zero.  The phase follows the GLOBAL round index (via
    ``start``), so a multi-stage profile sees one continuous day, not a
    sunrise per stage."""

    rate: float = 1.0
    period: int = 200
    amplitude: float = 0.8
    phase: int = 0

    def sample(self, rounds, shape, scale, rng, start=0):
        t = np.arange(start, start + rounds, dtype=np.float64)
        env = 1.0 + self.amplitude * np.sin(
            2.0 * np.pi * (t + self.phase) / max(self.period, 1))
        lam = np.maximum(self.rate * scale * env, 0.0)
        return rng.poisson(lam[:, None, None],
                           size=(rounds,) + tuple(shape)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Trace(ArrivalSpec):
    """Replay a recorded per-client arrival trace, cyclically.  ``counts``
    is ``(T0,)`` (broadcast over every sender) or ``(T0, G, S)``; the
    stage ``scale`` multiplies it with stochastic rounding (floor plus a
    Bernoulli on the fraction) so non-integer scaling stays unbiased
    while the matrix stays integer."""

    counts: Sequence

    def sample(self, rounds, shape, scale, rng, start=0):
        base = np.asarray(self.counts, np.float64)
        if base.ndim == 1:
            base = np.broadcast_to(base[:, None, None],
                                   (base.shape[0],) + tuple(shape))
        if base.shape[1:] != tuple(shape):
            raise ValueError(
                f"trace shape {base.shape} does not broadcast to "
                f"per-round shape {tuple(shape)}")
        idx = (start + np.arange(rounds)) % base.shape[0]
        scaled = base[idx] * scale
        lo = np.floor(scaled)
        frac = scaled - lo
        return (lo + (rng.random(scaled.shape) < frac)).astype(np.int64)
