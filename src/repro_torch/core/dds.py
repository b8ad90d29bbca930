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
a bound domain (``Domain.bind``) pushes one round of per-publisher sample
counts at a time through a :class:`repro_torch.core.group.GroupStream`.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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

        return group_mod.Group(
            self._group_config(samples_per_publisher, spindle,
                               target_delivered, **kw), device=device)

    def _group_config(self, samples_per_publisher: int, spindle: bool,
                      target_delivered: Optional[int], **kw):
        """The :class:`repro_torch.core.group.GroupConfig` :meth:`group`
        runs."""
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
        return group_mod.GroupConfig(
            members=tuple(range(self.n_nodes)), subgroups=subgroups,
            flags=flags, target_delivered=target_delivered, **kw)

    def bind(self, *, backend: str = "kernel", spindle: bool = True,
             device: DeviceLike = None, **kw) -> "BoundDomain":
        """Open a STREAMING session over this domain on ``device`` (the
        GPU unless ``"cpu"`` is named): per-round per-publisher sample
        counts in, one stacked round per push.

        Where :meth:`group` fixes ``samples_per_publisher`` upfront, a
        bound domain accepts each round's message counts as they happen —
        the data plane for workloads whose publish pattern only exists
        at run time, e.g. the serve fan-out
        (:mod:`repro_torch.serve.fanout`).  All topics still sweep as ONE
        stacked round."""
        g = self.group(samples_per_publisher=0, spindle=spindle,
                       device=device, **kw)
        return BoundDomain(self, g.stream(backend=backend))

    def sim_config(self, *, samples_per_publisher: int = 1000,
                   spindle: bool = True,
                   target_delivered: Optional[int] = None,
                   **kw) -> sim.SimConfig:
        """Deprecated: use ``domain.group(...).run(backend="des")``.

        A thin shim over the Group API: it returns the same SimConfig the
        des backend would lower to, and needs no device.  The deprecation
        warns once per process."""
        global _SIM_CONFIG_WARNED
        if not _SIM_CONFIG_WARNED:
            _SIM_CONFIG_WARNED = True
            warnings.warn(
                "Domain.sim_config is deprecated; use Domain.group() and "
                "Group.run(backend=...) instead", DeprecationWarning,
                stacklevel=2)
        cfg = self._group_config(samples_per_publisher, spindle,
                                 target_delivered)
        return cfg.to_sim_config(**kw)


@dataclasses.dataclass
class BoundDomain:
    """A domain bound to a :class:`repro_torch.core.group.GroupStream`:
    the topic-name-keyed front of the streaming entry point.

    ``push_round({topic_name: per_publisher_counts})`` publishes one
    round of samples (topics omitted from the mapping publish nothing
    that round — the null-send scheme covers their publishers) and
    returns the :class:`repro_torch.core.group.StreamView` watermarks;
    ``finish()`` drains and returns the unified report plus per-TOPIC
    delivery logs keyed by topic name.
    """

    domain: Domain
    stream: "object"                # repro_torch.core.group.GroupStream

    def __post_init__(self):
        self._gid = {t.name: g for g, t in enumerate(self.domain.topics)}

    @property
    def round(self) -> int:
        return self.stream.rounds

    def push_round(self, counts_by_topic=None):
        """One streamed round.  ``counts_by_topic`` maps topic name ->
        per-publisher sample counts (a scalar broadcasts over the topic's
        publishers; a sequence gives rank-ordered per-publisher counts,
        publisher order as declared in :meth:`Domain.create_topic`)."""
        ready = np.zeros(self.stream.shape, np.int32)
        for name, counts in (counts_by_topic or {}).items():
            if name not in self._gid:
                raise KeyError(f"unknown topic {name!r}; have "
                               f"{sorted(self._gid)}")
            gid = self._gid[name]
            n_pub = len(self.domain.topics[gid].publishers)
            counts = np.asarray(counts, np.int32)
            if counts.ndim == 0:
                counts = np.full(n_pub, int(counts), np.int32)
            if counts.shape != (n_pub,):
                raise ValueError(
                    f"topic {name!r} has {n_pub} publishers, got counts "
                    f"of shape {counts.shape}")
            ready[gid, :n_pub] = counts
        return self.stream.step(ready)

    def push_matrix(self, ready):
        """One streamed round from a raw ``(G, S_max)`` ready matrix:
        rows are topic-indexed in declaration order (``gid_of``); padded
        publisher lanes must be zero (the stream validates)."""
        return self.stream.step(ready)

    def gid_of(self, name: str) -> int:
        """Subgroup row of topic ``name`` in the stream's (G, S_max)
        matrices (declaration order)."""
        return self._gid[name]

    def topic_backlogs(self, view=None) -> Dict[str, np.ndarray]:
        """Per-topic window-throttled backlog, keyed by topic name: the
        SMC backpressure signal an admission policy gates on.  ``view``
        defaults to the stream's current watermarks."""
        v = self.stream.view() if view is None else view
        return {t.name: v.backlog[g, : len(t.publishers)].copy()
                for g, t in enumerate(self.domain.topics)}

    def finish(self, settle_max=None):
        """Drain to quiescence; returns ``(RunReport, {topic_name:
        DeliveryLog})``."""
        report, logs = self.stream.finish(settle_max=settle_max)
        named = {t.name: logs[g]
                 for g, t in enumerate(self.domain.topics) if g in logs}
        return report, named

    def reconfigure(self, view):
        """Drive a mid-stream view change through the virtual-synchrony
        cut (DESIGN.md Sec. 7): topics are restricted to the surviving
        members — a topic every member of which failed is dropped; a
        topic whose publishers all failed keeps its first member as a
        silent publisher slot, mirroring
        :meth:`repro_torch.core.group.Group.reconfigure` so topic indices
        stay aligned with the stream's subgroup ids — and the in-flight
        samples cross the cut exactly as
        :meth:`repro_torch.core.group.GroupStream.reconfigure` decides
        (delivered everywhere at the ragged trim, or resent by their
        surviving publishers in the new view's stream).

        Returns ``(new_bound, old_report, {topic_name: DeliveryLog})``:
        the re-bound domain to continue pushing rounds into, plus the
        closing epoch's report and cut-clipped per-topic logs."""
        alive = set(view.members)
        new_domain = Domain(n_nodes=self.domain.n_nodes)
        for t in self.domain.topics:
            members = [m for m in t.members if m in alive]
            if not members:
                continue                 # every member failed: topic dies
            pubs = tuple(p for p in t.publishers if p in alive) \
                or (members[0],)
            subs = tuple(s for s in t.subscribers if s in alive)
            new_domain.topics.append(dataclasses.replace(
                t, publishers=pubs, subscribers=subs))
        new_stream = self.stream.reconfigure(view)
        old_report = self.stream.group.last_report
        old_named = {t.name: self.stream.group.delivery_logs[g]
                     for g, t in enumerate(self.domain.topics)
                     if g in self.stream.group.delivery_logs}
        return BoundDomain(new_domain, new_stream), old_report, old_named


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


# Module-level so the once-ness survives Domain instances; tests reset it.
_SIM_CONFIG_WARNED = False
