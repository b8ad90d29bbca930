"""Scenario configuration shared by every backend: subgroup membership,
per-sender send patterns and the Spindle optimisation flags.

Only the configuration dataclasses live here for now.  The discrete-event
simulator that gives the reference package its ``des`` backend follows in
a later slice of the port; until then the port runs the ``graph`` and
``kernel`` backends of :mod:`repro_torch.core.group`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SubgroupSpec:
    members: Tuple[int, ...]          # node ids
    senders: Tuple[int, ...]          # subset of members, in rank order
    msg_size: int = 10240
    window: int = 100
    n_messages: int = 1000            # per sender (app messages)

    def __post_init__(self):
        assert set(self.senders) <= set(self.members)


@dataclasses.dataclass(frozen=True)
class SenderPattern:
    """Application sending behaviour for one (subgroup, sender)."""

    inter_send_delay_us: float = 0.0  # busy-wait after each send
    active: bool = True               # False => never sends (nulls cover it)
    # Per-sender app-message budget; None = the SubgroupSpec's n_messages.
    # The Group API lowers explicit per-sender send() counts through this.
    n_messages: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SpindleFlags:
    batch_receive: bool = True
    batch_delivery: bool = True
    batch_send: bool = True
    null_send: bool = True
    early_lock_release: bool = True
    batched_upcall: bool = True
    memcpy_delivery: bool = False
    memcpy_send: bool = False
    # DDS QoS knobs (Sec. 4.6): unordered skips the cross-node stability
    # wait (deliver in local receive order); disk_append models the
    # logged-storage QoS (SSD append in the delivery path).
    wait_stability: bool = True
    disk_append: bool = False

    @classmethod
    def baseline(cls) -> "SpindleFlags":
        return cls(batch_receive=False, batch_delivery=False,
                   batch_send=False, null_send=False,
                   early_lock_release=False, batched_upcall=False)

    @classmethod
    def spindle(cls) -> "SpindleFlags":
        return cls()
