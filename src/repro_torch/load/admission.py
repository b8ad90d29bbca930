"""Admission control and shed/stall policies (DESIGN.md Sec. 10).

The seam between open-loop arrivals and the protocol's finite resources.
Arrivals land in per-sender FIFO queues held by the harness; every round
the policy decides, per ``(subgroup, sender)`` lane, how many queued
messages to RELEASE into the stream's ready counts and how many to SHED
from the queue tail.  Whatever the policy releases beyond the SMC window
the protocol itself throttles into the stream backlog — that backlog is
the backpressure signal the policies gate on, so admission "lowers to"
the SMC window rather than duplicating it.

The honesty constraint: under overload something must give.  A policy
that never sheds (``AdmitAll``) lets queues and latency grow without
bound — useful as the uncontrolled baseline, and exactly what an honest
report must show as unbounded.  A bounding policy (``WindowSlack``,
``TokenBucket``) keeps p99 and queue depth finite by refusing work,
and the shed count is reported separately from goodput — the harness
never silently converges to closed-loop behavior.

The serve plane has its own resource model (request queues and KV
slots); :class:`ServeAdmission` is the equivalent policy there, lowered
by :meth:`repro_torch.serve.fanout.ReplicatedEngine.run` to queue-tail
sheds and watermark-aware ``stalled`` slots.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class AdmissionPolicy:
    """Per-round admission decision over the ``(G, S)`` lane grid.

    ``admit(round_no, queued, backlog, windows)`` receives the post-
    arrival queue depths, the stream's window-throttled backlog from the
    previous round's watermarks, and the per-subgroup SMC windows; it
    returns ``(release, shed)`` counts with ``release + shed <= queued``
    lane-wise.  Implementations may keep state (token buckets); the
    harness calls them once per round in round order.

    A policy that can run INSIDE the fused load program (the profile's
    rounds on the device, :mod:`repro_torch.load.harness`) additionally
    implements the ``fused_key`` / ``device_init`` / ``device_admit``
    triple: ``device_admit`` is the exact ``admit`` arithmetic in torch
    over an explicit state tensor, and ``fused_key`` is the hashable
    static description the program cache keys on.  The built-in policies
    all lower; a policy that returns ``None`` from :meth:`fused_key` (the
    default) falls the harness back to the per-round host loop —
    silently, because the two loops are bit-identical by contract."""

    def admit(self, round_no: int, queued: np.ndarray,
              backlog: np.ndarray, windows: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def fused_key(self) -> Optional[Tuple]:
        """Hashable static description for the fused-program cache, or
        ``None`` when this policy cannot be lowered to the device."""
        return None

    def device_init(self, shape: Tuple[int, int],
                    device=None) -> torch.Tensor:
        """Initial ``(G, S)``-shaped device state (stateless policies
        return an empty tensor)."""
        return torch.zeros((0,), dtype=torch.float32, device=device)

    def device_admit(self, state: torch.Tensor, queued: torch.Tensor,
                     backlog: torch.Tensor, windows: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One round of :meth:`admit` in torch arithmetic: ``(release,
        shed, state)`` over int32 lane grids.  Must mirror the host
        formulas bit for bit (the fused/unfused LoadReport equivalence
        tests gate on it)."""
        raise NotImplementedError

    def device_commit(self, state: torch.Tensor) -> None:
        """Install the post-run device state back onto the host policy
        (so a policy object reused after a fused run behaves exactly as
        it would after the host loop).  Stateless policies no-op."""


def _clip_decision(release, shed, queued):
    release = np.minimum(np.maximum(release, 0), queued)
    shed = np.minimum(np.maximum(shed, 0), queued - release)
    return release.astype(np.int64), shed.astype(np.int64)


@dataclasses.dataclass
class AdmitAll(AdmissionPolicy):
    """The uncontrolled baseline: release everything, shed nothing.
    Under overload the stream backlog (and hence latency) grows without
    bound — the behavior an honest saturation report must expose, not
    hide."""

    def admit(self, round_no, queued, backlog, windows):
        return queued.astype(np.int64), np.zeros_like(queued, np.int64)

    def fused_key(self):
        return ("admit-all",)

    def device_admit(self, state, queued, backlog, windows):
        return queued, torch.zeros_like(queued), state


@dataclasses.dataclass
class WindowSlack(AdmissionPolicy):
    """Backpressure-coupled admission: release only while the stream's
    window-throttled backlog has slack, shed the queue tail beyond a cap.

    Per lane, release ``max(0, inflight_limit - backlog)`` (default
    limit: 2x the subgroup's SMC window — one window in flight, one
    queued behind it), then drop whatever still exceeds ``queue_cap``
    from the TAIL (newest arrivals — the ones that would wait longest).
    Both latency and queue depth are thereby bounded: a released message
    waits at most ``queue_cap`` harness rounds' worth of drain plus
    ``inflight_limit`` in-stream messages, regardless of offered load."""

    inflight_limit: Optional[int] = None
    queue_cap: Optional[int] = 64

    def admit(self, round_no, queued, backlog, windows):
        if self.inflight_limit is not None:
            limit = np.full_like(queued, self.inflight_limit)
        else:
            limit = np.broadcast_to(2 * np.asarray(windows)[:, None],
                                    queued.shape)
        release = np.minimum(queued, np.maximum(limit - backlog, 0))
        if self.queue_cap is None:
            shed = np.zeros_like(queued)
        else:
            shed = np.maximum(queued - release - self.queue_cap, 0)
        return _clip_decision(release, shed, queued)

    def fused_key(self):
        return ("window-slack", self.inflight_limit, self.queue_cap)

    def device_admit(self, state, queued, backlog, windows):
        if self.inflight_limit is not None:
            limit = torch.full_like(queued, self.inflight_limit)
        else:
            limit = (2 * windows[:, None]).to(queued.dtype).expand(
                queued.shape)
        release = torch.minimum(queued, (limit - backlog).clamp(min=0))
        if self.queue_cap is None:
            shed = torch.zeros_like(queued)
        else:
            shed = (queued - release - self.queue_cap).clamp(min=0)
        return release, shed, state


@dataclasses.dataclass
class TokenBucket(AdmissionPolicy):
    """Classic rate limiter: each lane accrues ``rate`` tokens per round
    up to ``burst``; a release spends one token per message.  Optionally
    tail-drops beyond ``queue_cap`` like :class:`WindowSlack`.  Bounds
    the RELEASED rate (so the stream never saturates if ``rate`` is set
    below capacity) rather than reacting to backlog."""

    rate: float = 1.0
    burst: float = 8.0
    queue_cap: Optional[int] = 64
    # float32, matching the fused program's device state bit for bit
    # (the fused/unfused LoadReport equivalence gates on it)
    _tokens: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)

    def admit(self, round_no, queued, backlog, windows):
        if self._tokens is None:
            self._tokens = np.full(queued.shape, np.float32(self.burst),
                                   np.float32)
        self._tokens = np.minimum(self._tokens + np.float32(self.rate),
                                  np.float32(self.burst))
        release = np.minimum(queued, np.floor(self._tokens).astype(
            np.int64))
        self._tokens = (self._tokens
                        - release.astype(np.float32)).astype(np.float32)
        if self.queue_cap is None:
            shed = np.zeros_like(queued)
        else:
            shed = np.maximum(queued - release - self.queue_cap, 0)
        return _clip_decision(release, shed, queued)

    def fused_key(self):
        return ("token-bucket", float(self.rate), float(self.burst),
                self.queue_cap)

    def device_init(self, shape, device=None):
        if self._tokens is not None:
            return torch.as_tensor(self._tokens, dtype=torch.float32,
                                   device=device)
        return torch.full(shape, float(np.float32(self.burst)),
                          dtype=torch.float32, device=device)

    def device_admit(self, state, queued, backlog, windows):
        # float32 throughout, each step rounded as the host's numpy
        tokens = torch.minimum(state + float(np.float32(self.rate)),
                               torch.full_like(state, float(
                                   np.float32(self.burst))))
        release = torch.minimum(queued, tokens.floor().to(queued.dtype))
        tokens = tokens - release.to(torch.float32)
        if self.queue_cap is None:
            shed = torch.zeros_like(queued)
        else:
            shed = (queued - release - self.queue_cap).clamp(min=0)
        return release, shed, tokens

    def device_commit(self, state) -> None:
        self._tokens = state.detach().cpu().numpy().astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ServeAdmission:
    """Admission/shed/stall policy for the serve plane, applied by
    :meth:`repro_torch.serve.fanout.ReplicatedEngine.run`:

    * ``queue_cap`` — per-replica request-queue cap; arrivals beyond it
      are shed from the queue tail (newest first) and recorded with
      their round, bounding both queue depth and admitted-request wait.
    * ``stall_backlog`` — watermark-aware stall: a KV slot whose
      multicast lane has more than this many messages in flight
      (published-but-undelivered plus window-throttled backlog) decodes
      a null round until the watermark catches up — backpressure
      expressed through the slot's SMC window instead of unbounded ring
      occupancy."""

    queue_cap: Optional[int] = None
    stall_backlog: Optional[int] = None
