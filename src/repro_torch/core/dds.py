"""An OMG-DDS-style publish/subscribe layer over the Spindle multicast
(paper Sec. 4.6).

One top-level domain contains every participant, and one subgroup per
*topic* whose members are exactly the processes that publish or subscribe
to it.  On the ``graph``/``kernel`` backends a many-topic domain runs as
ONE stacked round loop — all topics' subgroups padded to a common shape —
so a domain with dozens of topics costs one receive-kernel launch per
round, not one per topic.

Four QoS levels (Sec. 4.6): UNORDERED, ATOMIC_MULTICAST, VOLATILE (copied
into subscriber memory) and LOGGED (appended to an SSD log).  Streaming
a bound domain (``Domain.bind``) follows in a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

from repro_torch import DeviceLike
from repro_torch.core import simulator as sim


class QoS(enum.Enum):
    UNORDERED = "unordered"
    ATOMIC_MULTICAST = "atomic"
    VOLATILE = "volatile"
    LOGGED = "logged"


def qos_flags(qos: QoS, base: Optional[sim.SpindleFlags] = None,
              ) -> sim.SpindleFlags:
    """Translate a QoS level into protocol flags layered on `base`."""
    base = base if base is not None else sim.SpindleFlags.spindle()
    if qos is QoS.UNORDERED:
        return dataclasses.replace(base, wait_stability=False)
    if qos is QoS.ATOMIC_MULTICAST:
        return base
    if qos is QoS.VOLATILE:
        return dataclasses.replace(base, memcpy_delivery=True)
    if qos is QoS.LOGGED:
        return dataclasses.replace(base, memcpy_delivery=True,
                                   disk_append=True)
    raise ValueError(qos)


@dataclasses.dataclass(frozen=True)
class Topic:
    """One DDS topic == one subgroup of its publishers + subscribers."""

    name: str
    topic_id: int                       # 8-bit topic number per OMG DDS
    publishers: Tuple[int, ...]         # node ids
    subscribers: Tuple[int, ...]
    sample_size: int = 10240
    qos: QoS = QoS.ATOMIC_MULTICAST
    window: int = 100

    def __post_init__(self):
        if not 0 <= self.topic_id < 256:
            raise ValueError("OMG DDS topic numbers are 8-bit")

    @property
    def members(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.publishers) | set(self.subscribers)))


@dataclasses.dataclass
class Domain:
    """A DDS domain: the top-level group plus its topics."""

    n_nodes: int
    topics: List[Topic] = dataclasses.field(default_factory=list)

    def create_topic(self, name: str, publishers: Sequence[int],
                     subscribers: Sequence[int], *, sample_size: int = 10240,
                     qos: QoS = QoS.ATOMIC_MULTICAST,
                     window: int = 100) -> Topic:
        if len(self.topics) >= 256:
            raise ValueError("domain is limited to 256 topics (8-bit ids)")
        for t in self.topics:
            if t.name == name:
                raise ValueError(f"duplicate topic {name!r}")
        topic = Topic(name=name, topic_id=len(self.topics),
                      publishers=tuple(publishers),
                      subscribers=tuple(subscribers),
                      sample_size=sample_size, qos=qos, window=window)
        self.topics.append(topic)
        return topic

    def group(self, *, samples_per_publisher: int = 1000,
              spindle: bool = True,
              target_delivered: Optional[int] = None,
              device: DeviceLike = None, **kw):
        """Build the unified :class:`repro_torch.core.group.Group` for this
        domain on ``device`` (the GPU unless ``"cpu"`` is named): one
        subgroup per topic, QoS lowered to protocol flags.  All topics
        must share a QoS for a single run (the protocol flags are
        global)."""
        from repro_torch.core import group as group_mod

        if not self.topics:
            raise ValueError("no topics")
        qos = self.topics[0].qos
        if any(t.qos is not qos for t in self.topics):
            raise ValueError("benchmark one QoS level per run")
        base = (sim.SpindleFlags.spindle() if spindle
                else sim.SpindleFlags.baseline())
        flags = qos_flags(qos, base)
        subgroups = tuple(
            sim.SubgroupSpec(members=t.members, senders=t.publishers,
                             msg_size=t.sample_size, window=t.window,
                             n_messages=samples_per_publisher)
            for t in self.topics)
        cfg = group_mod.GroupConfig(
            members=tuple(range(self.n_nodes)), subgroups=subgroups,
            flags=flags, target_delivered=target_delivered, **kw)
        return group_mod.Group(cfg, device=device)


def single_topic_domain(n_nodes: int, n_subscribers: int,
                        qos: QoS = QoS.ATOMIC_MULTICAST,
                        sample_size: int = 10240) -> Domain:
    """The paper's DDS benchmark: one publisher, varying subscribers,
    everyone on distinct nodes."""
    assert n_subscribers + 1 <= n_nodes
    d = Domain(n_nodes=n_nodes)
    d.create_topic("bench", publishers=[0],
                   subscribers=list(range(1, 1 + n_subscribers)),
                   sample_size=sample_size, qos=qos)
    return d


def many_topic_domain(n_nodes: int, n_topics: int, *,
                      subscribers_per_topic: int = 2,
                      qos: QoS = QoS.ATOMIC_MULTICAST,
                      sample_size: int = 4096,
                      window: int = 16) -> Domain:
    """``n_topics`` topics striped round-robin over the nodes (topic t is
    published by node ``t % n_nodes`` to the next
    ``subscribers_per_topic`` nodes); the whole domain runs as one
    stacked loop."""
    assert n_nodes >= 2 and subscribers_per_topic + 1 <= n_nodes
    d = Domain(n_nodes=n_nodes)
    for t in range(n_topics):
        pub = t % n_nodes
        subs = [(pub + 1 + k) % n_nodes
                for k in range(subscribers_per_topic)]
        d.create_topic(f"topic-{t}", publishers=[pub], subscribers=subs,
                       sample_size=sample_size, qos=qos, window=window)
    return d
