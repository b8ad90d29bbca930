"""The unified Derecho-style ``Group`` API on PyTorch, scheduled path.

One :class:`GroupConfig` describes a scenario (membership, subgroups,
:class:`~repro_torch.core.simulator.SpindleFlags`, cost/net models) and
:meth:`Group.run` executes it on one of four backends behind the
:class:`ProtocolBackend` protocol:

  * ``"des"``    — the two-phase discrete-event simulator of the paper's
                   testbed (:mod:`repro_torch.core.desgraph` then
                   :mod:`repro_torch.core.desreplay`), host code over the
                   calibrated cost model; its streams round on the numpy
                   mirror of the sweep.
  * ``"des-loop"`` — the legacy single-phase event loop
                   (:class:`repro_torch.core.simulator.Simulator`),
                   bit-identical to ``"des"``, kept for differential
                   testing; it does not stream.
  * ``"graph"``  — the fused predicate sweep (:mod:`repro_torch.core.sweep`)
                   with the plain ``max``-merge receive: the send pattern is
                   lowered to an ``app_schedule`` tensor and run round by
                   round on the device.
  * ``"kernel"`` — the same protocol with the receive predicate evaluated
                   by the SMC-sweep kernel
                   (:func:`repro_torch.kernels.ops.smc_sweep_watermark`),
                   launched once per round over every (subgroup, member,
                   sender) lane.

The graph and kernel backends return the same :class:`RunReport` and
per-subgroup total-order :class:`DeliveryLog`, bit-identical on integer
fields to the reference package's ``graph`` / ``pallas`` backends; the
DES backends equal the reference's ``des`` / ``des-loop`` bit for bit,
floats included, and launch nothing on the device.  All G subgroups run
as one stacked loop (padded to a common (N_max, S_max) with validity
masks), and a ``run_batch`` grid adds its points as one more leading
dimension.  The round loop never copies to the host: the traces come
back once, after it.

Usage::

    g = Group(cfg)                       # on the GPU; Group(cfg, device="cpu")
    h = g.subgroup(0)
    h.ordered_send(sender=0, n=100)
    h.on_delivery(lambda member, msg: ...)
    report = g.run(backend="kernel")

``Group.stream`` opens a :class:`GroupStream`: the same stacked round,
fed one round of message counts at a time (the serve plane's entry
point).  A view change (:meth:`Group.reconfigure`,
:meth:`GroupStream.reconfigure`, driven by
:class:`repro_torch.core.views.MembershipService`) crosses the
virtual-synchrony cut: messages underway are delivered everywhere at the
ragged trim or resent in the next view (:class:`EpochCarry`).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import (Any, Callable, Deque, Dict, List, Mapping, Optional,
                    Protocol, Sequence, Tuple)

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import costmodel, delivery as delivery_mod
from repro_torch.core import desgraph as desgraph_mod
from repro_torch.core import desreplay as desreplay_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core import simulator as sim
from repro_torch.core import sst
from repro_torch.core import sweep as sweep_mod
from repro_torch.kernels import ops

# SST row push size (bytes): the coalesced counter row (Sec. 2.2).
_ROW_BYTES = 64


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

# Re-exported so callers need only `repro_torch.api` / this module.
SubgroupSpec = sim.SubgroupSpec
SpindleFlags = sim.SpindleFlags
SenderPattern = sim.SenderPattern


@dataclasses.dataclass(frozen=True)
class GroupConfig:
    """One multicast scenario, independent of the substrate that runs it."""

    members: Tuple[int, ...]                     # top-level membership
    subgroups: Tuple[sim.SubgroupSpec, ...]
    flags: sim.SpindleFlags = sim.SpindleFlags.spindle()
    net: costmodel.NetworkModel = costmodel.RDMA_CX6
    host: costmodel.HostModel = costmodel.HOST_X86
    patterns: Tuple[Tuple[Tuple[int, int], sim.SenderPattern], ...] = ()
    target_delivered: Optional[int] = None
    max_time_us: float = 60e6
    # DES-plane knobs (charged by the des backends only, carried so a
    # SimConfig round-trips losslessly through the Group API)
    llc_bytes: int = 20 * 1024 * 1024
    upcall_extra_us: float = 0.0
    max_sweeps: int = 3_000_000
    idle_tick_us: float = 2.0
    # graph/kernel round budget; None = auto (max sends + settle rounds)
    rounds: Optional[int] = None
    epoch: int = 0                               # bumped by reconfigure()

    def __post_init__(self):
        members = set(self.members)
        for spec in self.subgroups:
            assert set(spec.members) <= members, \
                f"subgroup members {spec.members} outside group {members}"

    @property
    def n_nodes(self) -> int:
        return max(self.members) + 1 if self.members else 0

    def pattern(self, g: int, node: int) -> sim.SenderPattern:
        for (pg, pn), pat in self.patterns:
            if pg == g and pn == node:
                return pat
        return sim.SenderPattern()

    def to_sim_config(self, **overrides) -> sim.SimConfig:
        """Lower to the DES configuration (the ``des`` backend's input)."""
        kw = dict(n_nodes=self.n_nodes, subgroups=self.subgroups,
                  flags=self.flags, net=self.net, host=self.host,
                  patterns=self.patterns,
                  target_delivered=self.target_delivered,
                  max_time_us=self.max_time_us,
                  llc_bytes=self.llc_bytes,
                  upcall_extra_us=self.upcall_extra_us,
                  max_sweeps=self.max_sweeps,
                  idle_tick_us=self.idle_tick_us)
        kw.update(overrides)
        return sim.SimConfig(**kw)

    @classmethod
    def from_sim_config(cls, cfg: sim.SimConfig, **kw) -> "GroupConfig":
        return cls(members=tuple(range(cfg.n_nodes)),
                   subgroups=cfg.subgroups, flags=cfg.flags, net=cfg.net,
                   host=cfg.host, patterns=cfg.patterns,
                   target_delivered=cfg.target_delivered,
                   max_time_us=cfg.max_time_us,
                   llc_bytes=cfg.llc_bytes,
                   upcall_extra_us=cfg.upcall_extra_us,
                   max_sweeps=cfg.max_sweeps,
                   idle_tick_us=cfg.idle_tick_us, **kw)


def single_group(n_nodes: int, n_senders: Optional[int] = None,
                 msg_size: int = 10240, window: int = 100,
                 n_messages: int = 1000,
                 flags: sim.SpindleFlags = sim.SpindleFlags.spindle(),
                 **kw) -> GroupConfig:
    """One subgroup over ``n_nodes`` nodes — the quickstart scenario."""
    senders = tuple(range(n_senders if n_senders is not None else n_nodes))
    spec = sim.SubgroupSpec(members=tuple(range(n_nodes)), senders=senders,
                            msg_size=msg_size, window=window,
                            n_messages=n_messages)
    return GroupConfig(members=tuple(range(n_nodes)), subgroups=(spec,),
                       flags=flags, **kw)


# ---------------------------------------------------------------------------
# The unified run report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunReport:
    """Backend-independent result of one :meth:`Group.run`.

    ``delivered_app_msgs``/``delivered_null_msgs`` are summed over members;
    ``nulls_sent`` counts null *publishes*.  The time-domain numbers
    (throughput, latency, duration, rdma_writes) come from the calibrated
    RDMA cost model folded over the publish trace — modelled multicast
    time, not a measurement of the device; ``extras["wall_s"]`` is the
    host wall clock of the run.
    """

    backend: str
    throughput_GBps: float
    mean_latency_us: float
    p99_latency_us: float
    duration_us: float
    delivered_app_msgs: int
    delivered_null_msgs: int
    nulls_sent: int
    rdma_writes: int
    rounds: int                         # protocol rounds run
    per_node_throughput: List[float]
    stalled: bool
    send_batches: List[int] = dataclasses.field(default_factory=list)
    recv_batches: List[int] = dataclasses.field(default_factory=list)
    deliv_batches: List[int] = dataclasses.field(default_factory=list)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "throughput_GBps": round(self.throughput_GBps, 4),
            "mean_latency_us": round(self.mean_latency_us, 3),
            "p99_latency_us": round(self.p99_latency_us, 3),
            "delivered_app_msgs": self.delivered_app_msgs,
            "delivered_null_msgs": self.delivered_null_msgs,
            "nulls_sent": self.nulls_sent,
            "rdma_writes": self.rdma_writes,
            "stalled": self.stalled,
        }


@dataclasses.dataclass(frozen=True)
class Delivery:
    """One delivered application message (nulls never reach upcalls)."""

    subgroup: int
    seq: int                # round-robin sequence number
    sender_rank: int
    sender_index: int       # per-sender publish index (ring index)


@dataclasses.dataclass
class DeliveryLog:
    """The total-order publish log of one subgroup plus how far each
    member's delivery predicate got into it."""

    n_senders: int
    is_app: List[np.ndarray]            # per sender-rank: nullness per index
    delivered_seq: Dict[int, int]       # member node -> highest delivered seq

    def sequence(self, node: int, *, apps_only: bool = True
                 ) -> List[Tuple[int, int, bool]]:
        """Delivered (sender_rank, sender_index, is_app) at ``node`` in
        delivery order."""
        out = []
        for seq in range(self.delivered_seq.get(node, -1) + 1):
            rank, idx = seq % self.n_senders, seq // self.n_senders
            app = bool(idx < len(self.is_app[rank])
                       and self.is_app[rank][idx])
            if app or not apps_only:
                out.append((rank, idx, app))
        return out

    def app_null_counts(self, node: int) -> Tuple[int, int]:
        hi = self.delivered_seq.get(node, -1)
        batch = delivery_mod.DeliveryBatch(lo_seq=0, hi_seq=hi,
                                           n_senders=self.n_senders)
        return delivery_mod.split_app_and_null(batch, self.is_app)

    def app_flags_upto(self, hi: int) -> np.ndarray:
        """Nullness of seqs ``0..hi`` in the total order (False for seqs
        beyond any sender's logged publishes)."""
        flags = np.zeros(max(hi + 1, 0), dtype=bool)
        for r, log in enumerate(self.is_app):
            seqs = np.arange(len(log)) * self.n_senders + r
            m = seqs <= hi
            flags[seqs[m]] = np.asarray(log, dtype=bool)[: len(seqs)][m]
        return flags

    def truncate_to_app_target(self, target: int) -> None:
        """Clip each member's delivered prefix at its ``target``-th app
        message — the logical form of ``target_delivered``'s measurement
        window, applied identically on every backend."""
        hi_all = max(self.delivered_seq.values(), default=-1)
        if hi_all < 0:
            return
        cum = np.cumsum(self.app_flags_upto(hi_all))
        for node, hi in self.delivered_seq.items():
            if hi >= 0 and cum[hi] > target:
                self.delivered_seq[node] = int(
                    np.searchsorted(cum, target))


# ---------------------------------------------------------------------------
# Backend protocol + registry
# ---------------------------------------------------------------------------


class ProtocolBackend(Protocol):
    """One substrate that can execute a :class:`GroupConfig` scenario."""

    name: str

    def run(self, cfg: GroupConfig,
            counts: Dict[int, np.ndarray]) -> Tuple[RunReport,
                                                    Dict[int, DeliveryLog]]:
        """Execute the scenario.  ``counts[gid]`` is the per-sender-rank
        app-message count for subgroup ``gid``.  Returns the unified report
        plus one delivery log per subgroup."""
        ...


# name -> factory(device) -> backend
BACKENDS: Dict[str, Callable[[torch.device], ProtocolBackend]] = {}


def register_backend(name: str,
                     factory: Callable[[torch.device], ProtocolBackend]):
    BACKENDS[name] = factory


def get_backend(backend, device: DeviceLike = None) -> ProtocolBackend:
    """A backend by name, built for ``device``; an instance passes
    through."""
    if isinstance(backend, str):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; the port has "
                f"{sorted(BACKENDS)} ('kernel' is the counterpart of the "
                "reference's 'pallas')")
        return BACKENDS[backend](resolve_device(device))
    return backend


# ---------------------------------------------------------------------------
# The Group façade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochCarry:
    """What one membership epoch hands the next across the
    virtual-synchrony cut (DESIGN.md Sec. 7).

    Every field is indexed by the NEW view's subgroup ids and sender
    ranks.  ``resend[g][s]`` is how many of sender s's app messages were
    underway at the cut and must be re-published in the new view (the
    tail of that sender's sequence, so per-sender FIFO order holds).
    ``stable_apps[g][s]`` is the closing epoch's delta of apps delivered
    everywhere; ``app_base[g][s]`` the cumulative count across all prior
    epochs; ``cut_seq[g]`` the ragged-trim seq in the closing subgroup's
    total order."""

    from_epoch: int
    cut_seq: Tuple[int, ...]
    resend: Tuple[np.ndarray, ...]
    stable_apps: Tuple[np.ndarray, ...]
    app_base: Tuple[np.ndarray, ...]

    def total_resend(self) -> int:
        return int(sum(r.sum() for r in self.resend))


class SubgroupHandle:
    """Send/upcall handle for one subgroup — the Derecho user surface."""

    def __init__(self, group: "Group", gid: int):
        self.group = group
        self.gid = gid

    @property
    def spec(self) -> sim.SubgroupSpec:
        return self.group.cfg.subgroups[self.gid]

    def send(self, sender: Optional[int] = None, n: int = 1) -> None:
        """Queue ``n`` application messages from ``sender`` (a node id;
        defaults to the subgroup's first sender).  Explicit sends take
        over the whole subgroup: they replace the spec's ``n_messages``
        scenario default AND any per-sender pattern budgets — senders you
        do not ``send()`` to send nothing (nulls cover them)."""
        spec = self.spec
        sender = spec.senders[0] if sender is None else sender
        if sender not in spec.senders:
            raise ValueError(f"node {sender} is not a sender of "
                             f"subgroup {self.gid}")
        rank = spec.senders.index(sender)
        self.group._explicit.setdefault(self.gid, np.zeros(
            len(spec.senders), dtype=np.int64))[rank] += n

    # Every send is totally ordered; the two Derecho entry points are
    # therefore the same operation.
    ordered_send = send

    def on_delivery(self, fn: Callable[[int, Delivery], None]) -> None:
        """Register a delivery upcall ``fn(member_node, Delivery)``; fired
        (app messages only, in total order per member) after each run."""
        self.group._upcalls.setdefault(self.gid, []).append(fn)

    def delivered(self, node: int) -> List[Tuple[int, int, bool]]:
        """Delivered (sender_rank, sender_index, is_app) at ``node`` from
        the last run (apps only)."""
        log = self.group.delivery_logs.get(self.gid)
        if log is None:
            raise RuntimeError("run() first")
        return log.sequence(node)


class Group:
    """The one front door: configure once, run on any backend.

    ``device`` is where the protocol rounds run: ``None`` means the GPU
    (``RuntimeError`` if there is none); pass ``"cpu"`` for the plain
    PyTorch path on the host.  The DES backends run on the host whatever
    the device and allocate nothing on it; the device rule holds for
    them all the same."""

    def __init__(self, cfg: GroupConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._explicit: Dict[int, np.ndarray] = {}
        self._upcalls: Dict[int, List[Callable]] = {}
        self.delivery_logs: Dict[int, DeliveryLog] = {}
        self.last_report: Optional[RunReport] = None
        # virtual-synchrony epoch carry (DESIGN.md Sec. 7): resends of the
        # previous epoch, added to every run's counts
        self.carry: Optional[EpochCarry] = None
        # old gid -> new gid / old->new sender rank maps, set by
        # reconfigure() on the group it RETURNS (None on fresh groups)
        self._gid_map: Optional[Dict[int, int]] = None
        self._sender_maps: Optional[Dict[int, List[Tuple[int, int]]]] = None

    @classmethod
    def from_sim_config(cls, cfg: sim.SimConfig, device: DeviceLike = None,
                        **kw) -> "Group":
        return cls(GroupConfig.from_sim_config(cfg, **kw), device=device)

    def subgroup(self, gid: int) -> SubgroupHandle:
        if not 0 <= gid < len(self.cfg.subgroups):
            raise IndexError(gid)
        return SubgroupHandle(self, gid)

    @property
    def n_subgroups(self) -> int:
        return len(self.cfg.subgroups)

    def send_counts(self, gid: int,
                    cfg: Optional[GroupConfig] = None) -> np.ndarray:
        """Effective per-sender-rank app-message counts for one subgroup.

        Explicit queued ``send()`` calls take over the WHOLE subgroup: they
        replace both the spec's ``n_messages`` default and any
        ``SenderPattern.n_messages`` budgets.  Without explicit sends,
        pattern budgets override the spec default per sender.  Inactive
        patterns always mask to zero.  A virtual-synchrony ``carry``
        (resend counts from the previous epoch's cut) is added ON TOP."""
        cfg = self.cfg if cfg is None else cfg
        spec = cfg.subgroups[gid]
        explicit = self._explicit.get(gid)
        if explicit is not None and len(explicit) != len(spec.senders):
            raise ValueError(
                f"subgroup {gid} has queued explicit sends for "
                f"{len(explicit)} senders but the (overridden) spec has "
                f"{len(spec.senders)}; drop the override or re-queue")
        if explicit is not None:
            counts = explicit.copy()
        else:
            counts = np.full(len(spec.senders), spec.n_messages,
                             dtype=np.int64)
        for rank, node in enumerate(spec.senders):
            pat = cfg.pattern(gid, node)
            if not pat.active:
                counts[rank] = 0
            elif pat.n_messages is not None and explicit is None:
                counts[rank] = pat.n_messages
        if self.carry is not None:
            resend = self.carry.resend[gid]
            if len(resend) != len(spec.senders):
                raise ValueError(
                    f"subgroup {gid} carries resends for {len(resend)} "
                    f"senders but the (overridden) spec has "
                    f"{len(spec.senders)}; a sender-set override cannot "
                    "silently drop the previous epoch's resend set")
            counts = counts + resend.astype(counts.dtype)
        return counts

    # -- running -------------------------------------------------------------

    def run(self, backend="kernel", **overrides) -> RunReport:
        """Execute the configured scenario on ``backend`` (name or
        :class:`ProtocolBackend` instance) and fire delivery upcalls."""
        cfg = (dataclasses.replace(self.cfg, **overrides) if overrides
               else self.cfg)
        be = get_backend(backend, self.device)
        counts = {g: self.send_counts(g, cfg)
                  for g in range(len(cfg.subgroups))}
        report, logs = be.run(cfg, counts)
        self.delivery_logs = logs
        self.last_report = report
        self._fire_upcalls()
        return report

    def run_batch(self, backend="kernel", *, windows=None, null_send=None,
                  n_messages=None, devices: Optional[Sequence] = None
                  ) -> List[RunReport]:
        """Execute a grid of scenario variants as ONE batched loop.

        Each keyword is ``None`` (keep the configured value) or a sequence
        of per-point values; all given grids must share one length B.
        ``windows``/``n_messages`` replace every subgroup's setting at
        that point, ``null_send`` replaces the flag.  Every point, every
        subgroup, runs in the same round loop (the points are a leading
        tensor dimension); schedules are padded to a common round budget
        and per-point traces sliced back, so each report equals the
        corresponding sequential :meth:`run`.

        ``devices`` shards the grid on the ``graph`` and ``kernel``
        backends: one chunk a device over the largest count of them that
        divides the grid (:mod:`repro_torch.core.placement`; e.g. four
        ``cpu`` devices, or ``[cuda:0, cuda:0]``), every point's result
        unchanged.  Without it a group on a card shards over every card
        present (the reference's ``jax.devices()``), which on one card is
        the whole grid on it; a group on the CPU runs the grid whole.

        Returns one :class:`RunReport` per point; each report carries its
        delivery logs in ``extras["delivery_logs"]``.  Delivery upcalls do
        not fire (batch runs are measurement sweeps)."""
        grids = {name: list(vals) for name, vals in
                 (("windows", windows), ("null_send", null_send),
                  ("n_messages", n_messages)) if vals is not None}
        if not grids:
            raise ValueError("run_batch needs at least one grid "
                             "(windows=, null_send= or n_messages=)")
        sizes = {len(v) for v in grids.values()}
        if len(sizes) != 1:
            raise ValueError("grid lengths differ: " + str(
                {k: len(v) for k, v in grids.items()}))
        cfgs = []
        for i in range(sizes.pop()):
            cfg = self.cfg
            over: Dict[str, Any] = {}
            if windows is not None or n_messages is not None:
                over["subgroups"] = tuple(
                    dataclasses.replace(
                        s,
                        window=(int(windows[i]) if windows is not None
                                else s.window),
                        n_messages=(int(n_messages[i])
                                    if n_messages is not None
                                    else s.n_messages))
                    for s in cfg.subgroups)
            if null_send is not None:
                over["flags"] = dataclasses.replace(
                    cfg.flags, null_send=bool(null_send[i]))
            cfgs.append(dataclasses.replace(cfg, **over) if over else cfg)
        counts = [{g: self.send_counts(g, c)
                   for g in range(len(c.subgroups))} for c in cfgs]
        be = get_backend(backend, self.device)
        if devices is not None:
            if not isinstance(be, GraphBackend) or isinstance(be,
                                                              DESBackend):
                name = getattr(be, "name", be)
                raise ValueError(f"devices= shards the graph and kernel "
                                 f"backends' grid, not {name!r}'s")
            results = be.run_batch(cfgs, counts, devices=devices)
        elif hasattr(be, "run_batch"):
            results = be.run_batch(cfgs, counts)
        else:
            results = [be.run(c, k) for c, k in zip(cfgs, counts)]
        reports = []
        for report, logs in results:
            report.extras["delivery_logs"] = logs
            reports.append(report)
        return reports

    def stream(self, backend="kernel") -> "GroupStream":
        """Open a streaming session over this scenario: feed per-round
        per-sender app-message counts with :meth:`GroupStream.step` (all
        G subgroups sweep as ONE stacked round) and close with
        :meth:`GroupStream.finish` for the same :class:`RunReport` /
        delivery logs a scheduled run produces.  This is the serve-plane
        entry point: message arrivals that only exist at run time — a
        decode loop's admissions and emitted tokens — ride the multicast
        substrate round by round instead of as a precomputed schedule."""
        return GroupStream(self, backend)

    def _fire_upcalls(self):
        for gid, fns in self._upcalls.items():
            log = self.delivery_logs.get(gid)
            if log is None:
                continue
            spec = self.cfg.subgroups[gid]
            for member in spec.members:
                for rank, idx, _ in log.sequence(member):
                    d = Delivery(subgroup=gid,
                                 seq=idx * log.n_senders + rank,
                                 sender_rank=rank, sender_index=idx)
                    for fn in fns:
                        fn(member, d)

    # -- reconfiguration (virtual synchrony) ---------------------------------

    def reconfigure(self, view) -> "Group":
        """Install a new membership ``view``
        (:class:`repro_torch.core.views.View`): every subgroup is
        restricted to the surviving members (failed senders drop out; a
        subgroup whose senders all failed keeps its first member as a
        silent sender; one whose members all failed is dropped).  Returns
        a fresh ``Group`` for the new epoch on the same device.

        What crosses the epoch boundary (DESIGN.md Sec. 7): upcall
        registrations, and QUEUED explicit sends — messages handed to
        ``send()`` but never yet underway are the head of the resend set,
        remapped to the surviving sender ranks (a failed sender's queue
        dies with it).  Delivery logs do NOT carry: each epoch's log is
        its own total order.  In-flight state is carried by the streaming
        path (:meth:`GroupStream.reconfigure`), which installs its resend
        decision as ``carry`` on the Group it hands back."""
        alive = set(view.members)
        new_specs = []
        gid_map: Dict[int, int] = {}     # old gid -> new gid
        sender_maps: Dict[int, List[Tuple[int, int]]] = {}
        for gid, spec in enumerate(self.cfg.subgroups):
            members = tuple(m for m in spec.members if m in alive)
            senders = tuple(s for s in spec.senders if s in alive)
            if not members:
                continue                 # every member failed: subgroup dies
            sender_maps[gid] = [(spec.senders.index(s), new_rank)
                                for new_rank, s in enumerate(senders)]
            if not senders:
                senders = (members[0],)
            gid_map[gid] = len(new_specs)
            new_specs.append(dataclasses.replace(
                spec, members=members, senders=senders))
        patterns = tuple(((gid_map[g], n), p)
                         for (g, n), p in self.cfg.patterns
                         if g in gid_map and n in alive)
        cfg = dataclasses.replace(
            self.cfg, members=tuple(view.members),
            subgroups=tuple(new_specs), patterns=patterns,
            epoch=self.cfg.epoch + 1)
        g = Group(cfg, device=self.device)
        g._upcalls = {gid_map[gid]: list(fns)
                      for gid, fns in self._upcalls.items()
                      if gid in gid_map}
        for gid, new_gid in gid_map.items():
            queued = self._explicit.get(gid)
            if queued is None:
                continue
            remapped = np.zeros(len(new_specs[new_gid].senders), np.int64)
            for old_rank, new_rank in sender_maps[gid]:
                remapped[new_rank] = queued[old_rank]
            if remapped.any():
                g._explicit[new_gid] = remapped
        g._gid_map = gid_map
        g._sender_maps = sender_maps
        return g


# ---------------------------------------------------------------------------
# Lowering and the cost fold
# ---------------------------------------------------------------------------


def _lower_schedule(counts: np.ndarray, rounds: int) -> np.ndarray:
    """(S,) per-sender counts -> (T, S) app_schedule: one message per
    active round until each sender's budget is spent."""
    t = np.arange(rounds)[:, None]
    return (t < counts[None, :]).astype(np.int32)


def _cost_params(cfg: GroupConfig, spec: sim.SubgroupSpec) -> np.ndarray:
    """Lower the per-round cost model to six coefficients consumed by
    :func:`_fold_cost`: ``[base, post, per_msg, wire, row_writes, peers]``.

    Per round every member pushes its SST row (one coalesced 64 B write per
    peer, the ``base`` term); a sender that published ``k`` app messages
    additionally pushes them as one batched slot write of ``k`` slots per
    peer (``post + per_msg * k``).  The round takes as long as the busiest
    node's post+serialization charge plus one wire hop.
    """
    n = len(spec.members)
    if n <= 1:
        return np.zeros(6)
    slot = spec.msg_size + 8
    host, net = cfg.host, cfg.net
    base = host.lock_us + 3 * host.predicate_eval_us + \
        (n - 1) * (net.post_us + net.serialization(_ROW_BYTES))
    return np.array([base,
                     (n - 1) * net.post_us,
                     (n - 1) * net.serialization(slot),
                     net.wire_latency(min(slot, 4096)),
                     n * (n - 1),
                     n - 1])


def _fold_cost(app_pub: torch.Tensor, cost: torch.Tensor):
    """The cost model over the (..., T, S) publish trace with (..., 6) f32
    coefficients -> (..., T) per-round f32 time and int32 RDMA writes."""
    c = cost[..., None, :]                                     # (..., 1, 6)
    # Busiest sender per round: serialization is linear in k, so the
    # max-k sender is the argmax of post + per_msg * k.
    kmax = app_pub.amax(dim=-1)                                # (..., T)
    busiest = torch.where(kmax > 0, c[..., 1] + c[..., 2] * kmax, 0.0)
    round_t = c[..., 0] + busiest + c[..., 3]
    round_w = c[..., 4].to(torch.int32) + c[..., 5].to(torch.int32) * \
        (app_pub > 0).sum(dim=-1, dtype=torch.int32)
    return round_t, round_w


def fold_cost_np(app_pub: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Host-side mirror of :func:`_fold_cost`'s time term over one
    subgroup's (T, S) publish trace -> (T,) per-round microseconds."""
    app_pub = np.asarray(app_pub)
    kmax = app_pub.max(axis=1) if app_pub.size else \
        np.zeros(app_pub.shape[0])
    busiest = np.where(kmax > 0, cost[1] + cost[2] * kmax, 0.0)
    return cost[0] + busiest + cost[3]


def _kernel_receive(ring_window: int):
    """Receive-predicate override for the ``kernel`` backend: one launch
    of the watermark kernel sweeps every (point, subgroup, member, sender)
    ring of the round, rebuilding each slot counter inside the kernel.
    ``ring_window`` is the common ring width (the max window across the
    stack / grid); a ring wider than a subgroup's protocol window is
    harmless — slots are only reused after W messages and the publish cap
    uses the per-subgroup window.  ``valid`` masks padded lanes (None when
    unpadded) and is flattened over the same (…, N, S) plane."""

    def receive(pub_vis, recv_counts, valid=None):
        flat_valid = None if valid is None else \
            valid.expand(pub_vis.shape).reshape(-1)
        visible = ops.smc_sweep_watermark(
            pub_vis.reshape(-1), recv_counts.reshape(-1),
            window=ring_window, valid=flat_valid)
        return torch.maximum(recv_counts, visible.view(recv_counts.shape))

    return receive


def _stack_masks(members: Tuple[int, ...], senders: Tuple[int, ...]):
    """(G, N_max)/(G, S_max) suffix-padding validity masks — or
    ``(None, None)`` for a homogeneous stack (every subgroup fills the
    padded shape), which keeps the unmasked sweep arithmetic."""
    n_max, s_max = max(members), max(senders)
    member_masks = np.arange(n_max)[None, :] < np.asarray(members)[:, None]
    sender_masks = np.arange(s_max)[None, :] < np.asarray(senders)[:, None]
    if member_masks.all() and sender_masks.all():
        return None, None
    return member_masks, sender_masks


@dataclasses.dataclass
class _GraphAgg:
    """Accumulates one run's subgroup post-processing into report inputs."""

    duration: float = 0.0
    writes: int = 0
    delivered_app: int = 0
    delivered_null: int = 0
    nulls_sent: int = 0
    rounds: int = 0
    stalled: bool = False
    latencies: List[float] = dataclasses.field(default_factory=list)
    per_node_bytes: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    logs: Dict[int, DeliveryLog] = dataclasses.field(default_factory=dict)


class GraphBackend:
    """Runs the scenario through :func:`repro_torch.core.sweep.run_stacked`:
    all G subgroups, padded to a common (G, N_max, S_max) with validity
    masks, execute as one stacked round loop on ``device`` with the cost
    model folded on the device; delivery logs and latency round-pairs are
    then reconstructed per subgroup from the sliced traces with numpy.
    :meth:`run_batch` adds the grid points as a leading dimension of the
    same loop."""

    name = "graph"

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def _receive_fn(self, ring_window: int):
        """The receive predicate override (None = the ``max`` merge)."""
        return None

    @staticmethod
    def _rounds_for(cfg: GroupConfig, spec: sim.SubgroupSpec,
                    counts: np.ndarray) -> int:
        """Round budget: settle rounds for visibility/null drain, plus
        slack for ring-window throttling."""
        if cfg.rounds is not None:
            return cfg.rounds
        max_c = int(counts.max()) if len(counts) else 0
        return max_c + 2 * len(spec.members) + 8 + \
            3 * (max_c // max(spec.window, 1))

    # -- stacking: one group scenario -> padded program inputs ---------------

    def _stack(self, cfg: GroupConfig, counts: Dict[int, np.ndarray]):
        """Lower one scenario to per-subgroup shape tuples, round budgets,
        a (G, T_max, S_max) schedule stack and (G, 6) cost coefficients."""
        members = tuple(len(s.members) for s in cfg.subgroups)
        senders = tuple(len(s.senders) for s in cfg.subgroups)
        windows = tuple(s.window for s in cfg.subgroups)
        rounds = tuple(self._rounds_for(cfg, spec, counts[g])
                       for g, spec in enumerate(cfg.subgroups))
        t_max, s_max = max(rounds), max(senders)
        scheds = np.zeros((len(members), t_max, s_max), np.int32)
        for g in range(len(members)):
            scheds[g, :, : senders[g]] = _lower_schedule(counts[g], t_max)
        costs = np.stack([_cost_params(cfg, spec)
                          for spec in cfg.subgroups]).astype(np.float32)
        return members, senders, windows, rounds, scheds, costs

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _execute(self, scheds: torch.Tensor, costs: torch.Tensor,
                 windows: torch.Tensor, null_send, member_masks,
                 sender_masks, n_max: int, ring_window: int):
        """The device part of a run: the stacked round loop plus the cost
        fold, inputs and outputs on the inputs' device (``self.device``,
        or a grid chunk's device under :mod:`repro_torch.core.
        placement`), nothing copied to the host.  scheds: (G, T, S_max)
        with a Python-bool ``null_send``, or (B, G, T, S_max) with a (B,)
        bool tensor.
        Returns (batches, app_pub, nulls, round_t, round_w)."""
        states = sweep_mod.batch_states(n_max, scheds.shape[-1],
                                        tuple(scheds.shape[:-2]),
                                        scheds.device)
        receive_fn = self._receive_fn(ring_window)
        if scheds.dim() == 3:
            _, (batches, app_pub, nulls) = sweep_mod.run_stacked(
                states, scheds, windows=windows, null_send=null_send,
                member_masks=member_masks, sender_masks=sender_masks,
                receive_fn=receive_fn)
        else:
            _, (batches, app_pub, nulls) = sweep_mod.run_stacked_batch(
                states, scheds, windows=windows, null_sends=null_send,
                member_masks=member_masks, sender_masks=sender_masks,
                receive_fn=receive_fn)
        round_t, round_w = _fold_cost(app_pub, costs)
        return batches, app_pub, nulls, round_t, round_w

    def run(self, cfg: GroupConfig, counts: Dict[int, np.ndarray]
            ) -> Tuple[RunReport, Dict[int, DeliveryLog]]:
        agg = _GraphAgg()
        wall0 = time.perf_counter()
        if cfg.subgroups:
            members, senders, windows, rounds, scheds, costs = \
                self._stack(cfg, counts)
            member_masks, sender_masks = _stack_masks(members, senders)
            outs = self._run_device(
                members, scheds, costs, np.asarray(windows, np.int32),
                cfg.flags.null_send, member_masks, sender_masks,
                max(windows))
            self._finalize(cfg, counts, outs, rounds, agg)
        return self._report(agg, wall0), agg.logs

    def run_batch(self, cfgs: List[GroupConfig],
                  counts_list: List[Dict[int, np.ndarray]],
                  devices: Optional[Sequence] = None
                  ) -> List[Tuple[RunReport, Dict[int, DeliveryLog]]]:
        """Execute B scenario variants in ONE stacked round loop — every
        grid point, every subgroup.  All points must share membership
        shapes; schedules are padded to the common round budget and each
        point's traces sliced back to its own budget afterwards, so every
        point's results are identical to a sequential :meth:`run`.
        ``devices`` (default: :func:`~repro_torch.core.placement.
        default_devices` of this backend's device) shards the grid one
        chunk a device (:mod:`repro_torch.core.placement`) when more than
        one of them divides it."""
        if not cfgs:
            return []
        base = cfgs[0]
        for i, cfg in enumerate(cfgs[1:], start=1):
            if len(cfg.subgroups) != len(base.subgroups):
                raise ValueError(
                    f"run_batch points must share membership shapes; grid "
                    f"point {i} has {len(cfg.subgroups)} subgroups, grid "
                    f"point 0 has {len(base.subgroups)}")
            for gid, (s0, si) in enumerate(zip(base.subgroups,
                                               cfg.subgroups)):
                if (len(si.members) != len(s0.members)
                        or len(si.senders) != len(s0.senders)):
                    raise ValueError(
                        "run_batch points must share membership shapes; "
                        f"subgroup {gid} at grid point {i} has "
                        f"{len(si.members)} members / {len(si.senders)} "
                        f"senders vs grid point 0's {len(s0.members)} / "
                        f"{len(s0.senders)}")
        b = len(cfgs)
        wall0 = time.perf_counter()
        stacks = [self._stack(cfg, counts_list[i])
                  for i, cfg in enumerate(cfgs)]
        members, senders = stacks[0][0], stacks[0][1]
        t_max = max(max(st[3]) for st in stacks)
        s_max = max(senders)
        scheds = np.zeros((b, len(members), t_max, s_max), np.int32)
        for i, st in enumerate(stacks):
            scheds[i, :, : st[4].shape[1]] = st[4]
        windows = np.asarray([st[2] for st in stacks], np.int32)  # (B, G)
        nulls_on = np.asarray([cfg.flags.null_send for cfg in cfgs])
        costs = np.stack([st[5] for st in stacks])                # (B, G, 6)
        member_masks, sender_masks = _stack_masks(members, senders)
        if devices is None:
            devices = placement_mod.default_devices(self.device)
        outs = self._run_device(members, scheds, costs, windows, nulls_on,
                                member_masks, sender_masks,
                                int(windows.max()), devices)
        results = []
        for i in range(b):
            agg = _GraphAgg()
            self._finalize(cfgs[i], counts_list[i],
                           [o[i] for o in outs], stacks[i][3], agg)
            # one wall clock covers the whole grid — stamp it under a
            # batch key so nobody mistakes it for a per-point cost
            results.append((self._report(agg, wall0,
                                         wall_key="batch_wall_s"),
                            agg.logs))
        return results

    def _run_device(self, members, scheds, costs, windows, null_send,
                    member_masks, sender_masks, ring_window: int,
                    devices: Optional[Sequence] = None) -> List[np.ndarray]:
        """Copy the lowered inputs to the device, run :meth:`_execute`,
        and copy its five traces back (the only device-to-host copies of a
        run).  A batch grid shards over ``devices`` when
        :func:`~repro_torch.core.placement.shard_count` gives more than
        one chunk; otherwise it runs whole on ``self.device``."""
        dev = self._to_device
        if not isinstance(null_send, bool):
            null_send = dev(null_send)
        masks = (None, None) if member_masks is None else \
            (dev(member_masks), dev(sender_masks))
        execute = self._execute
        if devices is not None:
            n_shards = placement_mod.shard_count(scheds.shape[0], devices)
            if n_shards > 1:
                execute = placement_mod.shard_over_batch(
                    self._execute, list(devices)[:n_shards],
                    n_batched_args=4)
        outs = execute(dev(scheds), dev(costs), dev(windows), null_send,
                       *masks, max(members), ring_window)
        return [o.cpu().numpy() for o in outs]

    # -- host-side post-processing -------------------------------------------

    def _finalize(self, cfg: GroupConfig, counts: Dict[int, np.ndarray],
                  outs: List[np.ndarray], rounds: Tuple[int, ...],
                  agg: _GraphAgg) -> None:
        """Slice one run's stacked (G, T_max, ...) traces back to each
        subgroup's own round budget and real membership, reconstruct the
        delivery logs, apply the target-delivered measurement window, and
        accumulate report inputs."""
        parts = []
        for gid, spec in enumerate(cfg.subgroups):
            n_g, s_g, t_g = len(spec.members), len(spec.senders), rounds[gid]
            point = [outs[0][gid, :t_g, :n_g], outs[1][gid, :t_g, :s_g],
                     outs[2][gid, :t_g, :s_g], outs[3][gid, :t_g],
                     outs[4][gid, :t_g]]
            log, lat = self._reconstruct(spec, point[0], point[1], point[2])
            parts.append((gid, spec, point, log, lat))
        cross_target = (cfg.target_delivered is not None
                        and len(cfg.subgroups) > 1)
        if cfg.target_delivered is not None:
            if cross_target:
                _clip_target_stacked(cfg, parts)
            else:
                parts[0][3].truncate_to_app_target(cfg.target_delivered)
        for gid, spec, point, log, lat in parts:
            self._account(cfg, spec, gid, counts[gid], rounds[gid], point,
                          log, lat, agg,
                          per_subgroup_stall=not cross_target)
        if cross_target:
            agg.stalled = agg.stalled or _stalled_across_subgroups(
                cfg, counts, agg.logs)

    def _account(self, cfg: GroupConfig, spec: sim.SubgroupSpec,
                 gid: int, c: np.ndarray, rounds: int,
                 arrays: List[np.ndarray], log: DeliveryLog,
                 lat_pairs: np.ndarray, agg: _GraphAgg, *,
                 per_subgroup_stall: bool = True) -> None:
        """Accumulate one subgroup's post-processed traces into the
        report inputs."""
        batches, app_pub, nulls, round_t, round_w = arrays
        agg.logs[gid] = log
        agg.rounds += rounds
        agg.nulls_sent += int(nulls.sum())
        agg.writes += int(round_w.astype(np.int64).sum())
        end_time = np.cumsum(round_t.astype(np.float64))
        if rounds:
            agg.duration = max(agg.duration, float(end_time[-1]))
        if len(lat_pairs):
            pr, dr = lat_pairs[:, 0], lat_pairs[:, 1]
            start = np.where(pr > 0, end_time[np.maximum(pr - 1, 0)], 0.0)
            agg.latencies.extend((end_time[dr] - start).tolist())
        for node in spec.members:
            a, nl = log.app_null_counts(node)
            agg.delivered_app += a
            agg.delivered_null += nl
            agg.per_node_bytes[node] = \
                agg.per_node_bytes.get(node, 0.0) + a * spec.msg_size
        if per_subgroup_stall:
            total_app = int(c.sum())
            need = total_app if cfg.target_delivered is None else \
                min(cfg.target_delivered, total_app)
            if any(log.app_null_counts(node)[0] < need
                   for node in spec.members):
                agg.stalled = True

    def _report(self, agg: _GraphAgg, wall0: float,
                wall_key: str = "wall_s") -> RunReport:
        per_node = [b / agg.duration / 1e3
                    for b in agg.per_node_bytes.values()
                    if agg.duration > 0 and b > 0]
        lat = np.array(agg.latencies) if agg.latencies else np.array([0.0])
        return RunReport(
            backend=self.name,
            throughput_GBps=float(np.mean(per_node)) if per_node else 0.0,
            mean_latency_us=float(lat.mean()),
            p99_latency_us=float(np.percentile(lat, 99)),
            duration_us=agg.duration,
            delivered_app_msgs=agg.delivered_app,
            delivered_null_msgs=agg.delivered_null,
            nulls_sent=agg.nulls_sent,
            rdma_writes=agg.writes,
            rounds=agg.rounds,
            per_node_throughput=per_node,
            stalled=agg.stalled,
            extras={wall_key: time.perf_counter() - wall0},
        )

    @staticmethod
    def _reconstruct(spec: sim.SubgroupSpec, batches: np.ndarray,
                     app_pub: np.ndarray, nulls: np.ndarray):
        """Rebuild the per-sender nullness log and (publish_round,
        delivery_round) latency samples from the per-round trace, fully
        vectorized.  Within a round a sender publishes its app messages
        before its nulls.  Returns the log plus a (K, 2) int array of
        latency round-pairs sampled at member position 0."""
        n_s = len(spec.senders)
        rounds = batches.shape[0]
        is_app: List[np.ndarray] = []
        pub_round: List[np.ndarray] = []
        for s in range(n_s):
            a = app_pub[:, s].astype(np.int64)
            total = a + nulls[:, s].astype(np.int64)
            rnd = np.repeat(np.arange(rounds), total)
            start = np.cumsum(total) - total          # exclusive prefix
            offset = np.arange(total.sum()) - np.repeat(start, total)
            is_app.append(offset < np.repeat(a, total))
            pub_round.append(rnd)
        delivered_num = np.cumsum(batches, axis=0) - 1   # (T, N)
        final = delivered_num[-1] if rounds else \
            np.full(len(spec.members), -1)
        delivered = {node: int(final[pos])
                     for pos, node in enumerate(spec.members)}
        lat = np.zeros((0, 2), np.int64)
        if rounds and int(final[0]) >= 0:
            col = delivered_num[:, 0]
            seqs = np.arange(int(final[0]) + 1)
            ranks, idxs = seqs % n_s, seqs // n_s
            maxlen = max(len(x) for x in is_app)
            flags = np.zeros((n_s, maxlen), bool)
            rnds = np.zeros((n_s, maxlen), np.int64)
            for s in range(n_s):
                flags[s, : len(is_app[s])] = is_app[s]
                rnds[s, : len(pub_round[s])] = pub_round[s]
            m = flags[ranks, idxs]
            lat = np.stack([rnds[ranks[m], idxs[m]],
                            np.searchsorted(col, seqs[m])], axis=1)
        log = DeliveryLog(n_senders=n_s, is_app=is_app,
                          delivered_seq=delivered)
        return log, lat


def _clip_target_stacked(cfg: GroupConfig, parts) -> None:
    """Apply the ``target_delivered`` measurement window to a
    multi-subgroup stacked run.

    Every subgroup runs on ONE shared round timeline, so the window is
    cross-subgroup: for each member, find the earliest shared round at
    which its app deliveries summed over its subgroups reach the target,
    clip each subgroup's delivered prefix for that member to its value at
    that round, then clip within-subgroup overshoot at the target."""
    target = cfg.target_delivered
    per_member: Dict[int, List[Tuple[DeliveryLog, int, np.ndarray,
                                     np.ndarray]]] = {}
    for gid, spec, point, log, lat in parts:
        batches = point[0]
        if not len(batches):
            continue
        delivered_num = np.cumsum(batches.astype(np.int64), axis=0) - 1
        hi = int(delivered_num.max(initial=-1))
        # app_cum[k] = app messages among the first k seqs of the order
        app_cum = np.concatenate(
            [[0], np.cumsum(log.app_flags_upto(hi))]).astype(np.int64)
        for pos, node in enumerate(spec.members):
            col = delivered_num[:, pos]                       # (t_g,)
            apps = app_cum[col + 1]         # apps delivered by round r
            per_member.setdefault(node, []).append((log, node, col, apps))
    for node, entries in per_member.items():
        t_shared = max(len(col) for _, _, col, _ in entries)
        total = np.zeros(t_shared, np.int64)
        for _, _, col, apps in entries:
            pad = t_shared - len(apps)
            total += np.concatenate(
                [apps, np.full(pad, apps[-1] if len(apps) else 0)])
        hit = np.nonzero(total >= target)[0]
        if not len(hit):
            continue                     # target never reached: keep all
        cut = int(hit[0])
        for log, node_, col, _ in entries:
            log.delivered_seq[node_] = int(col[min(cut, len(col) - 1)])
    for gid, spec, point, log, lat in parts:
        log.truncate_to_app_target(target)


def _stalled_across_subgroups(cfg: GroupConfig,
                              counts: Dict[int, np.ndarray],
                              logs: Mapping[int, DeliveryLog]) -> bool:
    """Multi-subgroup target_delivered stall check: a member stalls when
    its app deliveries summed over its subgroups fall short of the target
    (capped by what its subgroups could supply at all)."""
    delivered: Dict[int, int] = {}
    avail: Dict[int, int] = {}
    for gid, spec in enumerate(cfg.subgroups):
        total_app = int(counts[gid].sum())
        for node in spec.members:
            delivered[node] = delivered.get(node, 0) + \
                logs[gid].app_null_counts(node)[0]
            avail[node] = avail.get(node, 0) + total_app
    return any(delivered[node] < min(cfg.target_delivered, avail[node])
               for node in delivered)


class KernelBackend(GraphBackend):
    """The graph protocol with the receive predicate evaluated by the SMC
    sweep kernel: per round one launch of
    :func:`repro_torch.kernels.ops.smc_sweep_watermark` over the flattened
    (…, member, sender) plane of every subgroup, with an explicit lane
    validity mask for padded stacks.  On CUDA tensors that is the Hopper
    kernel; on CPU tensors its plain twin."""

    name = "kernel"

    def _receive_fn(self, ring_window: int):
        return _kernel_receive(ring_window)


# ---------------------------------------------------------------------------
# "des" / "des-loop" backends — the discrete-event simulator.  "des" is
# the two-phase simulate-then-replay split (DESIGN.md Sec. 12):
# repro_torch.core.desgraph timestamps the event timeline,
# repro_torch.core.desreplay replays the emitted graph.  "des-loop" is the
# legacy single-phase event loop, kept for differential testing; both
# produce bit-identical results by construction.  Host code: neither
# launches a kernel nor touches the device.
# ---------------------------------------------------------------------------


def _des_logs(groups) -> Dict[int, DeliveryLog]:
    """Delivery logs from final per-subgroup DES state (either phase-1
    ``DesGraph.groups`` or the legacy ``Simulator.groups``)."""
    logs = {}
    for g in groups:
        is_app = [~np.isnan(g.gen_log[s][: int(g.gen_len[s])])
                  for s in range(g.n_s)]
        delivered = {node: int(g.deliv_seen[g.member_pos[node],
                                            g.member_pos[node]])
                     for node in g.spec.members}
        logs[g.gid] = DeliveryLog(n_senders=g.n_s, is_app=is_app,
                                  delivered_seq=delivered)
    return logs


def _sum_delivered(logs: Mapping[int, DeliveryLog]) -> Tuple[int, int]:
    a = n = 0
    for log in logs.values():
        for node in log.delivered_seq:
            da, dn = log.app_null_counts(node)
            a, n = a + da, n + dn
    return a, n


def _des_report(name: str, cfg: GroupConfig, result: sim.SimResult,
                groups) -> Tuple[RunReport, Dict[int, DeliveryLog]]:
    """Shared DES report assembly: both the two-phase ``des`` path and
    the legacy ``des-loop`` lower their :class:`SimResult` and final
    group state through this, so bit-identity between them is a
    statement about the simulators, not the reporting glue."""
    logs = _des_logs(groups)
    if cfg.target_delivered is not None:
        for log in logs.values():
            log.truncate_to_app_target(cfg.target_delivered)
    # app/null accounting comes from the (possibly clipped) delivery
    # logs so it always matches what delivered()/upcalls expose;
    # throughput/latency stay the DES's modelled timing
    n_app, n_null = _sum_delivered(logs)
    report = RunReport(
        backend=name,
        throughput_GBps=result.throughput_GBps,
        mean_latency_us=result.mean_latency_us,
        p99_latency_us=result.p99_latency_us,
        duration_us=result.duration_us,
        delivered_app_msgs=n_app,
        delivered_null_msgs=n_null,
        nulls_sent=result.nulls_sent,
        rdma_writes=result.rdma_writes,
        rounds=result.sweeps,
        per_node_throughput=result.per_node_throughput,
        stalled=result.stalled,
        send_batches=result.send_batches,
        recv_batches=result.recv_batches,
        deliv_batches=result.deliv_batches,
        extras={"post_time_us": result.post_time_us,
                "predicate_time_us": result.predicate_time_us,
                "sender_blocked_us": result.sender_blocked_us},
    )
    return report, logs


def _des_device(device: DeviceLike) -> Optional[torch.device]:
    """The device a DES backend records (for the streams and fused
    programs built over it); the DES itself never touches it, so no
    device is asked for when none is named."""
    return None if device is None else resolve_device(device)


class DESLoopBackend:
    """The legacy single-phase DES event loop (``des-loop``), retained
    for differential testing of the two-phase ``des`` path
    (DESIGN.md Sec. 12).  Not streamable — use ``des`` for that."""

    name = "des-loop"

    def __init__(self, device: DeviceLike = None):
        self.device = _des_device(device)

    def run(self, cfg: GroupConfig, counts: Dict[int, np.ndarray]
            ) -> Tuple[RunReport, Dict[int, DeliveryLog]]:
        sim_cfg = self._lower(cfg, counts)
        simulator = sim.Simulator(sim_cfg)
        result = simulator.run()
        return _des_report(self.name, cfg, result, simulator.groups)

    @staticmethod
    def _lower(cfg: GroupConfig, counts: Dict[int, np.ndarray]
               ) -> sim.SimConfig:
        """Per-sender counts lower to ``SenderPattern.n_messages``
        overrides (count 0 = inactive)."""
        patterns = {(g, n): p for (g, n), p in cfg.patterns}
        specs = []
        for gid, spec in enumerate(cfg.subgroups):
            c = counts[gid]
            specs.append(dataclasses.replace(
                spec, n_messages=int(c.max()) if len(c) else 0))
            for rank, node in enumerate(spec.senders):
                base = patterns.get((gid, node), sim.SenderPattern())
                patterns[(gid, node)] = dataclasses.replace(
                    base, active=base.active and int(c[rank]) > 0,
                    n_messages=int(c[rank]))
        return cfg.to_sim_config(
            subgroups=tuple(specs),
            patterns=tuple(patterns.items()))


class DESBackend(GraphBackend):
    """The two-phase DES (DESIGN.md Sec. 12), the ``des`` path.

    Scheduled runs execute phase 1
    (:func:`repro_torch.core.desgraph.simulate`, the slimmed event-level
    pass emitting the compact event graph) then phase 2
    (:func:`repro_torch.core.desreplay.replay`, the vectorized
    reconstruction), bit-identical to the legacy ``des-loop``.

    Streaming (:class:`GroupStream`) runs on the numpy round mirror
    (``stream_numpy``): the same int32 arithmetic as
    :func:`repro_torch.core.sweep.step_backlog`, evaluated on the host,
    driven through the exact GraphBackend trim/carry/log machinery
    inherited here — so streamed des rounds, cut epochs and
    :class:`EpochCarry` contents are bit-identical to graph/kernel
    streams fed the same ready rows.  Nothing of it runs on the device.
    """

    name = "des"
    # GroupStream: rounds on the numpy mirror
    # (repro_torch.core.desreplay.stream_program_np), not the device
    stream_numpy = True

    def __init__(self, device: DeviceLike = None):
        self.device = _des_device(device)

    def run(self, cfg: GroupConfig, counts: Dict[int, np.ndarray]
            ) -> Tuple[RunReport, Dict[int, DeliveryLog]]:
        sim_cfg = DESLoopBackend._lower(cfg, counts)
        graph = desgraph_mod.simulate(sim_cfg)
        result = desreplay_mod.replay(graph)
        return _des_report(self.name, cfg, result, graph.groups)

    def run_batch(self, cfgs: List[GroupConfig],
                  counts_list: List[Dict[int, np.ndarray]]
                  ) -> List[Tuple[RunReport, Dict[int, DeliveryLog]]]:
        """Sequential per-point runs (the DES has no batched program), so
        grids stay comparable point for point with the other backends."""
        return [self.run(c, k) for c, k in zip(cfgs, counts_list)]


# ---------------------------------------------------------------------------
# Streaming execution — per-round message counts on the stacked substrate
# ---------------------------------------------------------------------------

# The reference vmaps its one-subgroup cost fold over G; the port's fold
# already takes G as a leading dimension.
_fold_cost_stacked = _fold_cost

# Fused round programs: loops that EMBED the stream round body on the
# device (the fused serve plane, repro_torch.serve.fused, and the fused
# load profile, repro_torch.load.harness), each one round captured as a
# CUDA graph (repro_torch.core.graphloop.RoundProgram).  Keyed by the
# caller's full static tuple: scenario shape AND whatever the round body
# closes over (model config, round budgets, the buffers it writes in
# place), so a warm run of the same shape on the same engines is pure
# replay.  Each build appends one TRACE_EVENTS entry (on the card, the
# build is the capture), so "how many programs did this run build" is a
# delta of trace_snapshot().  The history is bounded, as the
# reference's.
TRACE_MAXLEN = 4096
TRACE_EVENTS: Deque[Tuple[Tuple[int, ...], Tuple[int, ...], str]] = \
    collections.deque(maxlen=TRACE_MAXLEN)
_FUSED_PROGRAMS: Dict[Tuple, Any] = {}


def trace_snapshot() -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], str],
                              ...]:
    """Immutable copy of the program-build history (newest last): take a
    snapshot before, subtract its length after."""
    return tuple(TRACE_EVENTS)


def trace_reset() -> int:
    """Clear the program-build history; returns how many entries were
    dropped.  Does NOT evict built programs."""
    n = len(TRACE_EVENTS)
    TRACE_EVENTS.clear()
    return n


def fused_stream_program(key: Tuple, build: Callable[[], Any]):
    """Compile-once cache for stream-composed fused programs that own
    all their buffers (the load plane's; a fused serve program holds its
    engines' caches and is kept on its ``ReplicatedEngine``).  ``key``
    must be a hashable static description of everything ``build()``'s
    program closes over; ``build`` is called once per key and appends its
    own TRACE_EVENTS entry."""
    prog = _FUSED_PROGRAMS.get(key)
    if prog is None:
        prog = _FUSED_PROGRAMS[key] = build()
    return prog


@dataclasses.dataclass(frozen=True)
class StreamView:
    """Host-side watermark snapshot after one streamed round.

    ``delivered_num[g, m]`` is member position ``m``'s highest delivered
    total-order seq in subgroup ``g``; ``published[g, s]`` sender rank
    ``s``'s total publishes (apps + nulls); ``backlog[g, s]`` its
    window-throttled still-queued app messages.  Padded lanes beyond a
    subgroup's real ``n_members``/``n_senders`` carry garbage — always
    slice with the per-subgroup sizes (as the helpers here do).
    """

    round: int
    delivered_num: np.ndarray            # (G, N_max)
    published: np.ndarray                # (G, S_max)
    backlog: np.ndarray                  # (G, S_max)
    n_members: Tuple[int, ...]
    n_senders: Tuple[int, ...]
    # the round's publish trace (None on a bare GroupStream.view() —
    # only a step() carries what it just published)
    app_pub: Optional[np.ndarray] = None     # (G, S_max)
    nulls: Optional[np.ndarray] = None       # (G, S_max)

    def sender_delivered(self, gid: int) -> np.ndarray:
        """(S_g,) — how many of each sender rank's publishes (apps and
        nulls) EVERY real member of subgroup ``gid`` has delivered: the
        per-sender delivery watermark (seq ``i*S + s`` delivered means
        sender ``s``'s first ``i+1`` publishes are)."""
        n_g, s_g = self.n_members[gid], self.n_senders[gid]
        d = int(self.delivered_num[gid, :n_g].min())
        ranks = np.arange(s_g)
        return np.where(d >= ranks, (d - ranks) // s_g + 1, 0)

    def sender_drained(self, gid: int) -> np.ndarray:
        """(S_g,) bool — sender rank has no queued backlog and every one
        of its publishes so far is delivered at every member of ``gid``
        (the slot-free condition of the serve plane)."""
        s_g = self.n_senders[gid]
        return ((self.backlog[gid, :s_g] == 0)
                & (self.sender_delivered(gid)
                   >= self.published[gid, :s_g]))


def host_array(x) -> np.ndarray:
    """A stream leaf on the host: a numpy array as it is (a des stream's
    own), a tensor copied from its device."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GroupStream:
    """Streaming execution of one :class:`Group` scenario.

    Where :meth:`Group.run` lowers a fixed per-sender message count to a
    schedule upfront, a stream accepts the (G, S_max) app-message counts
    of each round as they happen — the entry point for workloads whose
    send pattern only exists at run time (the serve plane's decode
    loop).  Every :meth:`step` sweeps ALL subgroups as one stacked round
    on the group's device (:func:`repro_torch.core.sweep.stream_stacked`;
    on the ``kernel`` backend that is one receive-kernel launch) and
    copies the round's traces and watermarks to the host in ONE read,
    returned as a :class:`StreamView` the caller can gate on.  On the
    ``des`` backend the round is the host-side numpy mirror
    (:func:`repro_torch.core.desreplay.stream_program_np`): the same
    int32 arithmetic, no device tensor and no read.
    :meth:`finish` drains to quiescence and post-processes the
    accumulated round traces through the exact :class:`GraphBackend`
    machinery scheduled runs use, so the resulting :class:`RunReport` and
    delivery logs compare like-for-like with ``run``/``run_batch``
    (``graph`` and ``kernel`` streams fed identical rounds are
    bit-identical).  :meth:`reconfigure` closes the stream at a view
    change's cut and hands its in-flight state to the next epoch's
    stream."""

    def __init__(self, group: Group, backend="kernel"):
        be = get_backend(backend, group.device)
        if not isinstance(be, GraphBackend):
            raise ValueError(
                "streaming runs on the stacked graph/kernel/des substrate; "
                f"got {getattr(be, 'name', backend)!r}")
        cfg = group.cfg
        if not cfg.subgroups:
            raise ValueError("no subgroups")
        self.group = group
        self.backend = be
        self.device = be.device
        # des streams round on the host-side numpy mirror of the same
        # int32 sweep arithmetic (DESIGN.md Sec. 12): bit-identical
        # rounds, and nothing allocated on the device
        self._numpy = bool(getattr(be, "stream_numpy", False))
        self._n = tuple(len(s.members) for s in cfg.subgroups)
        self._s = tuple(len(s.senders) for s in cfg.subgroups)
        self._w = tuple(s.window for s in cfg.subgroups)
        self.n_max, self.s_max = max(self._n), max(self._s)
        g_n = len(self._n)
        member_masks, sender_masks = _stack_masks(self._n, self._s)
        self._null_send = cfg.flags.null_send
        self._receive = be._receive_fn(max(self._w))
        if self._numpy:
            self._masks = (member_masks, sender_masks)
            self._program = desreplay_mod.stream_program_np(
                self._w, self._null_send)
            self._states = desreplay_mod.batch_states_np(
                self.n_max, self.s_max, g_n)
        else:
            self._masks = (None, None) if member_masks is None else (
                torch.as_tensor(member_masks, device=self.device),
                torch.as_tensor(sender_masks, device=self.device))
            self._windows = torch.as_tensor(np.asarray(self._w, np.int32),
                                            device=self.device)
            self._states = sweep_mod.batch_states(self.n_max, self.s_max,
                                                  g_n, self.device)
        self._costs = np.stack([_cost_params(cfg, spec)
                                for spec in cfg.subgroups]).astype(
                                    np.float32)
        self._enqueued = [np.zeros(s, np.int64) for s in self._s]
        # virtual-synchrony epoch carry: the previous epoch's resend set
        # starts out as this epoch's backlog — the undelivered tail
        # re-publishes ahead of new traffic, per-sender FIFO intact — and
        # counts as enqueued here (it must deliver in THIS view)
        self.carry = group.carry
        self.closed = False
        backlogs0 = np.zeros((g_n, self.s_max), np.int32)
        if self.carry is not None:
            for g, resent in enumerate(self.carry.resend):
                backlogs0[g, : len(resent)] = resent
                self._enqueued[g] += resent.astype(np.int64)
        self._backlogs = backlogs0 if self._numpy else \
            torch.as_tensor(backlogs0, device=self.device)
        # host copy of (delivered_num, published, backlog), refreshed by
        # each step's one device-to-host read (a des stream's own arrays)
        self._host = (np.full((g_n, self.n_max), -1, np.int32),
                      np.zeros((g_n, self.s_max), np.int32), backlogs0)
        # running per-sender publish totals, so watermark queries
        # (app_publish_index) answer "not published yet" in O(1)
        self._app_cum = np.zeros((g_n, self.s_max), np.int64)
        self._pub_cum = np.zeros((g_n, self.s_max), np.int64)
        self._batches: List[np.ndarray] = []
        self._app_pub: List[np.ndarray] = []
        self._nulls: List[np.ndarray] = []
        self._wall0 = time.perf_counter()
        self.rounds = 0

    @property
    def shape(self) -> Tuple[int, int]:
        """(G, S_max) — what :meth:`step` expects."""
        return len(self._n), self.s_max

    @property
    def n_members(self) -> Tuple[int, ...]:
        """Per-subgroup real member counts (lanes beyond are padding)."""
        return self._n

    @property
    def n_senders(self) -> Tuple[int, ...]:
        """Per-subgroup real sender counts (lanes beyond are padding)."""
        return self._s

    @property
    def windows(self) -> Tuple[int, ...]:
        """Per-subgroup SMC window (the backpressure bound an admission
        policy throttles against)."""
        return self._w

    @property
    def cost_params(self) -> np.ndarray:
        """(G, 6) cost-model coefficients (see :func:`_cost_params`),
        consumable by :func:`fold_cost_np` for host-side time folds."""
        return self._costs.copy()

    def traces(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The accumulated round traces, stacked: ``(batches (G, T, N),
        app_pub (G, T, S), nulls (G, T, S))`` for the T rounds streamed
        so far; empty T=0 arrays before any step."""
        g, s = self.shape
        if not self.rounds:
            z = np.zeros((g, 0, self.n_max), np.int64)
            return z, np.zeros((g, 0, s), np.int64), \
                np.zeros((g, 0, s), np.int64)
        return (np.stack(self._batches, axis=1),
                np.stack(self._app_pub, axis=1),
                np.stack(self._nulls, axis=1))

    def absorb(self, states, backlogs, batches, app_pub, nulls,
               enqueued) -> None:
        """Install round traces that were executed OUTSIDE this stream —
        inside a fused round program that embedded the stream round body
        (:func:`repro_torch.core.sweep.step_backlog` via
        :func:`fused_stream_program`; the fused serve plane and the fused
        load profile) — as if :meth:`step` had streamed them.

        ``states``/``backlogs`` are the post-run carry (a
        :class:`~repro_torch.core.sweep.SweepState` of (G, …) tensors or
        arrays, and a (G, S_max) backlog; copied, on the stream's
        device, or into int32 numpy arrays on a des stream);
        ``batches``/``app_pub``/``nulls`` the per-round traces
        as ``(T, G, ...)`` arrays or length-T lists of per-round
        ``(G, ...)`` rows; ``enqueued`` the per-subgroup per-rank app
        totals the rounds enqueued.  After absorbing, :meth:`finish`
        post-processes through the exact :class:`GraphBackend` machinery
        — a fused run's report and delivery logs are the per-round loop's
        by construction.  Only valid on a stream with no rounds streamed
        yet; an epoch CARRY is fine — the fused serve plane absorbs each
        post-cut epoch into the reconfigured stream, whose carry-seeded
        backlog/enqueued state the fused program took as its initial
        operands (``enqueued`` must then count only the absorbed rounds'
        events, which add onto the carry seed)."""
        if self.rounds or self.closed:
            raise RuntimeError("absorb needs a stream with no rounds "
                               "streamed (fresh or carry-seeded)")
        g, s_max = self.shape
        batches = [np.asarray(b, np.int64) for b in batches]
        app_pub = [np.asarray(p, np.int64) for p in app_pub]
        nulls = [np.asarray(x, np.int64) for x in nulls]
        if len(batches) != len(app_pub) or len(batches) != len(nulls):
            raise ValueError("trace lengths disagree")
        for b, p, x in zip(batches, app_pub, nulls):
            if b.shape != (g, self.n_max) or p.shape != (g, s_max) \
                    or x.shape != (g, s_max):
                raise ValueError("trace rows must be (G, N_max)/"
                                 "(G, S_max) shaped")

        if self._numpy:
            def own(x):
                return np.array(host_array(x), np.int32)
        else:
            def own(x):
                return torch.as_tensor(x).to(self.device, torch.int32,
                                             copy=True)

        self._states = sweep_mod.SweepState(**{
            f.name: own(getattr(states, f.name))
            for f in dataclasses.fields(sweep_mod.SweepState)})
        self._backlogs = own(backlogs)
        self._host = tuple(host_array(x) for x in (
            self._states.delivered_num, self._states.published,
            self._backlogs))
        self._batches, self._app_pub, self._nulls = batches, app_pub, \
            nulls
        for p, x in zip(app_pub, nulls):
            self._app_cum += p
            self._pub_cum += p + x
        for gid, s_g in enumerate(self._s):
            self._enqueued[gid] += np.asarray(enqueued[gid],
                                              np.int64)[:s_g]
        self.rounds = len(batches)

    def step(self, ready) -> StreamView:
        """One protocol round: ``ready[g, s]`` app messages become ready
        at sender rank ``s`` of subgroup ``g`` (padded lanes must be 0).
        Window-throttled messages are carried in the backlog, exactly as
        the scheduled loop does."""
        if self.closed:
            raise RuntimeError(
                "stream closed by a view change; continue on the stream "
                "reconfigure() returned")
        ready = np.asarray(ready, np.int32)
        if ready.shape != self.shape:
            raise ValueError(f"ready must be {self.shape}, got "
                             f"{ready.shape}")
        for g, s_g in enumerate(self._s):
            if ready[g, s_g:].any():
                raise ValueError(
                    f"subgroup {g} has {s_g} senders but ready names "
                    f"padded lanes {np.nonzero(ready[g, s_g:])[0] + s_g}")
            self._enqueued[g] += ready[g, :s_g].astype(np.int64)
        if self._numpy:
            return self._record(*self._step_numpy(ready))
        (self._states, self._backlogs), (batch, pub, nulls) = \
            sweep_mod.stream_stacked(
                self._states, self._backlogs,
                torch.as_tensor(ready, device=self.device),
                windows=self._windows, null_send=self._null_send,
                member_masks=self._masks[0], sender_masks=self._masks[1],
                receive_fn=self._receive)
        # the round's one device-to-host read: traces plus watermarks
        parts = (batch, pub, nulls, self._states.delivered_num,
                 self._states.published, self._backlogs)
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        batch, pub, nulls, deliv, published, backlog = np.split(
            flat, np.cumsum([p.numel() for p in parts])[:-1])
        g_n = len(self._n)
        batch, deliv = (x.reshape(g_n, self.n_max) for x in (batch, deliv))
        pub, nulls, published, backlog = (
            x.reshape(g_n, self.s_max)
            for x in (pub, nulls, published, backlog))
        return self._record(batch, pub, nulls, deliv, published, backlog)

    def _step_numpy(self, ready: np.ndarray):
        """A des round on the numpy mirror: no device tensor, no read."""
        masks = () if self._masks[0] is None else self._masks
        (self._states, self._backlogs), (batch, pub, nulls) = \
            self._program(self._states, self._backlogs, ready, *masks)
        return (batch, pub, nulls, self._states.delivered_num,
                self._states.published, self._backlogs)

    def _record(self, batch, pub, nulls, deliv, published,
                backlog) -> StreamView:
        """Append one round's host traces and watermarks."""
        self._host = (deliv, published, backlog)
        self._batches.append(batch)
        self._app_pub.append(pub)
        self._nulls.append(nulls)
        self._app_cum += pub
        self._pub_cum += pub + nulls
        self.rounds += 1
        return dataclasses.replace(self.view(), app_pub=pub, nulls=nulls)

    def view(self) -> StreamView:
        deliv, published, backlog = self._host
        return StreamView(round=self.rounds, delivered_num=deliv,
                          published=published, backlog=backlog,
                          n_members=self._n, n_senders=self._s)

    def app_publish_index(self, gid: int, rank: int,
                          k: int) -> Optional[int]:
        """Publish index (0-based, counting apps AND nulls) of sender
        ``rank``'s ``k``-th app publish (1-based) in subgroup ``gid``,
        from the accumulated round traces — or None if fewer than ``k``
        apps have been published yet.  The serve fan-out pins its
        slot-release watermarks on this (apps precede nulls within a
        round).  The common "still window-throttled" answer is O(1); the
        trace scan runs only once a hold's k-th app has published."""
        if k <= 0 or self._app_cum[gid, rank] < k:
            return None
        apps = np.asarray([r[gid, rank] for r in self._app_pub], np.int64)
        nulls = np.asarray([r[gid, rank] for r in self._nulls], np.int64)
        app_cum = np.cumsum(apps)
        r = int(np.searchsorted(app_cum, k))
        pub_before = int(np.cumsum(apps + nulls)[r] - apps[r] - nulls[r])
        return pub_before + int(k - (app_cum[r] - apps[r])) - 1

    def quiescent(self, view: Optional[StreamView] = None) -> bool:
        """No backlog anywhere and every PUBLISHED message delivered by
        every real member (stricter than "the round-robin prefix is
        delivered": a sender whose last window-throttled app publishes
        just as delivery catches up sits beyond the prefix until the
        null-send scheme covers the lagging ranks).  With null-send off
        it may never hold, which :meth:`finish`'s fixed-point exit
        handles."""
        v = self.view() if view is None else view
        for g, (n_g, s_g) in enumerate(zip(self._n, self._s)):
            if v.backlog[g, :s_g].any():
                return False
            counts = v.published[g, :s_g].astype(np.int64)
            if not counts.any():
                continue
            ranks = np.arange(s_g)
            last_seq = (counts - 1) * s_g + ranks
            need = int(last_seq[counts > 0].max())
            if (v.delivered_num[g, :n_g] < need).any():
                return False
        return True

    def _unchanged_since(self, states: sweep_mod.SweepState,
                         backlogs: torch.Tensor) -> bool:
        """Whether the last round left every state leaf and the backlog
        as they were (one device-to-host read)."""
        if self._numpy:
            return np.array_equal(backlogs, self._backlogs) and all(
                np.array_equal(getattr(states, f.name),
                               getattr(self._states, f.name))
                for f in dataclasses.fields(states))
        same = [(getattr(states, f.name) == getattr(self._states, f.name)
                 ).all() for f in dataclasses.fields(states)]
        same.append((backlogs == self._backlogs).all())
        return bool(torch.stack(same).all())

    def finish(self, settle_max: Optional[int] = None
               ) -> Tuple[RunReport, Dict[int, DeliveryLog]]:
        """Drain with zero-ready rounds until quiescent, then reconstruct
        delivery logs and the unified report from the accumulated traces.
        Also installs the logs on the owning Group and fires its delivery
        upcalls, mirroring :meth:`Group.run`.

        The drain runs until quiescence or a protocol FIXED POINT (a
        zero-ready round that changes nothing can never be followed by
        one that does — every predicate is monotone in the state), which
        covers scenarios that never quiesce (``null_send=False`` with
        uneven sender counts).  ``settle_max`` optionally caps the drain
        (the capped-off remainder reports as ``stalled``)."""
        if self.closed:
            raise RuntimeError(
                "stream closed by a view change; finish the stream "
                "reconfigure() returned")
        zeros = np.zeros(self.shape, np.int32)
        settled = 0
        while not self.quiescent():
            if settle_max is not None and settled >= settle_max:
                break
            prev = (self._states, self._backlogs)
            self.step(zeros)
            settled += 1
            if settle_max is None and self._unchanged_since(*prev):
                break                        # fixed point: done evolving
        agg = self._aggregate()
        if self.rounds and self._host[2].any():
            agg.stalled = True                # gave up with work queued
        report = self.backend._report(agg, self._wall0)
        report.extras["streamed_rounds"] = self.rounds
        self.group.delivery_logs = agg.logs
        self.group.last_report = report
        self.group._fire_upcalls()
        return report, agg.logs

    def _aggregate(self, app_pub=None, nulls=None) -> _GraphAgg:
        """Run the accumulated round traces through the exact
        :class:`GraphBackend` post-processing a scheduled run uses (the
        cost fold runs on the host copies).  ``app_pub``/``nulls`` take
        already-stacked (G, T, S) traces, so the cut path, which needs
        them for the stable-apps count anyway, does not stack them
        twice."""
        agg = _GraphAgg()
        if self.rounds:
            batches = np.stack(self._batches, axis=1)       # (G, T, N)
            if app_pub is None:
                app_pub = np.stack(self._app_pub, axis=1)   # (G, T, S)
            if nulls is None:
                nulls = np.stack(self._nulls, axis=1)
            round_t, round_w = _fold_cost_stacked(
                torch.as_tensor(app_pub.astype(np.int32)),
                torch.as_tensor(self._costs))
            outs = [batches, app_pub, nulls, round_t.numpy(),
                    round_w.numpy()]
            counts = {g: self._enqueued[g] for g in range(len(self._s))}
            self.backend._finalize(self.group.cfg, counts, outs,
                                   (self.rounds,) * len(self._n), agg)
        return agg

    # -- the virtual-synchrony cut (view changes mid-stream) -----------------

    def reconfigure(self, view) -> "GroupStream":
        """Close this epoch at the virtual-synchrony cut and hand its
        in-flight state to a new stream for ``view`` (DESIGN.md Sec. 7).

        Wedge semantics: no settle rounds run — the cut is taken from the
        SST watermarks exactly as they stand.  Per subgroup the ragged
        trim is the highest seq received by every SURVIVING member
        (:func:`repro_torch.core.sst.ragged_trim` over ``received_num``,
        read from the device once, here); every surviving member's
        delivery advances exactly TO the trim, so the closing epoch's log
        is identical at every survivor (*everywhere*), while everything
        beyond the trim is delivered *nowhere*.  Undelivered app messages
        of surviving senders — published-but-unstable plus the
        window-throttled backlog — become the new stream's initial
        backlog: the FIFO tail, resent in the new view.  A failed
        sender's unstable messages die with it.

        The closing epoch's cut-clipped logs and report are installed on
        the owning Group and its upcalls fire, mirroring :meth:`finish`
        (the report carries ``extras["view_change"]``).  The returned
        stream belongs to ``self.group.reconfigure(view)``, carries an
        :class:`EpochCarry` and runs on the same backend and device; a
        change that keeps the padded stack shape keeps the same round
        (one receive-kernel launch a round on ``kernel``)."""
        if self.closed:
            raise RuntimeError("stream already closed by a view change")
        cfg = self.group.cfg
        alive = set(view.members)
        new_group = self.group.reconfigure(view)
        gid_map, sender_maps = new_group._gid_map, new_group._sender_maps
        # the cut's one device-to-host read
        received = host_array(self._states.received_num)    # (G, N_max)
        _, app_pub, nulls = self.traces()                    # (G, T, S)
        cut_seqs: Dict[int, int] = {}
        stable: Dict[int, np.ndarray] = {}
        for gid, spec in enumerate(cfg.subgroups):
            n_g, s_g = self._n[gid], self._s[gid]
            alive_pos = np.asarray([m in alive for m in spec.members])
            cut = sst.ragged_trim(received[gid, :n_g], alive_pos)
            pubs_at_cut = sst.sender_counts(cut + 1, s_g)
            stable[gid] = np.asarray(
                [delivery_mod.apps_in_publish_prefix(
                    app_pub[gid, :, s], nulls[gid, :, s],
                    int(pubs_at_cut[s])) for s in range(s_g)], np.int64)
            cut_seqs[gid] = cut
        resend_t, stable_t, base_t, cut_t = [], [], [], []
        for old_gid in sorted(gid_map):
            new_gid = gid_map[old_gid]
            s_new = len(new_group.cfg.subgroups[new_gid].senders)
            resend = np.zeros(s_new, np.int64)
            stb = np.zeros(s_new, np.int64)
            base = np.zeros(s_new, np.int64)
            for old_rank, new_rank in sender_maps[old_gid]:
                stb[new_rank] = stable[old_gid][old_rank]
                resend[new_rank] = (self._enqueued[old_gid][old_rank]
                                    - stb[new_rank])
                prev = (int(self.carry.app_base[old_gid][old_rank])
                        if self.carry is not None else 0)
                base[new_rank] = prev + stb[new_rank]
            resend_t.append(resend)
            stable_t.append(stb)
            base_t.append(base)
            cut_t.append(cut_seqs[old_gid])
        new_group.carry = EpochCarry(
            from_epoch=cfg.epoch, cut_seq=tuple(cut_t),
            resend=tuple(resend_t), stable_apps=tuple(stable_t),
            app_base=tuple(base_t))
        self._close_at_cut(cut_seqs, alive, new_group.carry,
                           app_pub, nulls, stable)
        return new_group.stream(backend=self.backend)

    def _close_at_cut(self, cut_seqs: Dict[int, int], alive,
                      carry: EpochCarry, app_pub, nulls,
                      stable_by_old_rank: Dict[int, np.ndarray]) -> None:
        """Finalize the closing epoch's logs and report with every
        surviving member's delivery advanced to the ragged trim."""
        cfg = self.group.cfg
        agg = self._aggregate(app_pub, nulls)
        for gid, spec in enumerate(cfg.subgroups):
            log = agg.logs.get(gid)
            if log is None:
                continue
            for node in spec.members:
                if node in alive:
                    log.delivered_seq[node] = cut_seqs[gid]
        # re-derive the log-dependent accounting after the cut advance
        # (latency samples keep their in-protocol rounds: cut-advanced
        # deliveries have no delivery round to sample)
        agg.delivered_app = agg.delivered_null = 0
        agg.per_node_bytes = {}
        for gid, spec in enumerate(cfg.subgroups):
            log = agg.logs.get(gid)
            if log is None:
                continue
            for node in spec.members:
                n_app, n_null = log.app_null_counts(node)
                agg.delivered_app += n_app
                agg.delivered_null += n_null
                agg.per_node_bytes[node] = \
                    agg.per_node_bytes.get(node, 0.0) + \
                    n_app * spec.msg_size
        report = self.backend._report(agg, self._wall0)
        report.extras["streamed_rounds"] = self.rounds
        report.extras["view_change"] = {
            "cut_seq": {g: int(c) for g, c in cut_seqs.items()},
            "resend_msgs": carry.total_resend(),
            # stable app counts in the OLD view's rank space (the carry's
            # stable_apps are remapped to the new view and drop failed
            # senders): a failed sender's stable prefix is only visible
            # here.  The serve plane accounts a dead slot's delivered
            # apps with it; gradsync caps a dead contributor with it.
            "stable_apps_by_old_rank": {
                g: s.copy() for g, s in stable_by_old_rank.items()},
        }
        self.group.delivery_logs = agg.logs
        self.group.last_report = report
        self.group._fire_upcalls()
        self.closed = True


register_backend("des", DESBackend)
register_backend("des-loop", DESLoopBackend)
register_backend("graph", GraphBackend)
register_backend("kernel", KernelBackend)
