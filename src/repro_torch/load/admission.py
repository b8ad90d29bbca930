"""Admission policy of the serve plane."""

from __future__ import annotations

import dataclasses
from typing import Optional


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
