"""repro_torch.chaos — seeded fault injection over every plane.

One import gives the chaos surface::

    from repro_torch.chaos import FaultSpec, chaos_soak

    spec = FaultSpec(rounds=24, suspect_rate=0.15, cascade_prob=0.4)
    report = chaos_soak(api.Group(cfg), spec, seed=11, backend="kernel")

:class:`FaultSpec` samples a deterministic schedule of suspicions
(optionally cascading mid-wedge), joins, slot-node kills, and stall
bursts; :func:`chaos_soak` drives a ``Group``/``GroupStream``,
``ReplicatedEngine``, or ``BucketSyncStream`` through it under
load-plane traffic and asserts the virtual-synchrony invariants
(exactly-once, per-sender FIFO, monotone ``app_base``,
everywhere-or-nowhere) after every installed view — DESIGN.md Sec. 7.
"""

from repro_torch.chaos.faults import FaultEvent, FaultSpec, events_by_round
from repro_torch.chaos.soak import ChaosReport, InvariantViolation, chaos_soak

__all__ = [
    "ChaosReport", "FaultEvent", "FaultSpec", "InvariantViolation",
    "chaos_soak", "events_by_round",
]
