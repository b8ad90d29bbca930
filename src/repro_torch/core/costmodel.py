"""Calibrated cost model the Group backends charge per protocol round.

``RDMA_CX6`` is the paper's testbed: 16 machines, 100 Gbps (12.5 GB/s)
InfiniBand, one-sided RDMA writes.  Figure 1 gives wire latency 1.73 us
at 1 B rising to 2.46 us at 4 KB; Section 3.2 reports ~1 us of CPU time
to post one RDMA write.  These are modelled times of the multicast the
protocol simulates, not times of the device that runs the port.

``H100_SXM`` is that device, for the dry-run's roofline
(:mod:`repro_torch.launch.dryrun`): the datasheet rates of the card, its
node's NVLink and the network between nodes.  The reference's TPU
constants have no counterpart here.

The protocol models' times are microseconds, their sizes bytes and
their bandwidths bytes/us (GB/s == 1e3 bytes/us); a ChipModel's rates
are per second, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

GB_PER_S = 1e3  # bytes per microsecond


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Latency/bandwidth model of one node's NIC + link.

    Wire latency of a single write of ``size`` bytes is
    ``base_latency_us + size * lat_per_byte_us`` (the paper's Fig. 1 line),
    while sustained throughput is limited by ``link_bw``.
    """

    name: str
    post_us: float          # CPU time to post one write/collective
    base_latency_us: float  # wire latency at size ~ 0
    lat_per_byte_us: float  # latency slope (pipelined, != 1/link_bw)
    link_bw: float          # bytes/us, serialization bandwidth per direction
    cacheline: int = 64
    inline_max: int = 0     # writes <= this avoid the payload DMA fetch

    def wire_latency(self, size: int) -> float:
        """One-way latency of a single write of `size` bytes (Fig. 1)."""
        return self.base_latency_us + size * self.lat_per_byte_us

    def serialization(self, size: int) -> float:
        """Link occupancy of a write of `size` bytes."""
        return size / self.link_bw


@dataclasses.dataclass(frozen=True)
class HostModel:
    """CPU-side costs of the polling (predicate) thread."""

    predicate_eval_us: float   # evaluate one predicate over current state
    slot_poll_us: float        # inspect one SMC slot counter
    upcall_us: float           # deliver one message to the application
    upcall_batch_us: float     # fixed overhead of one (batched) upcall
    lock_us: float             # acquire+release the SST lock once
    memcpy_base_us: float      # memcpy latency intercept
    memcpy_per_byte_us: float  # memcpy slope (Fig. 14)
    app_send_api_us: float = 1.0   # slot acquire + send() call overhead

    def memcpy(self, size: int) -> float:
        return self.memcpy_base_us + size * self.memcpy_per_byte_us


# Fit of Fig. 1: lat(1 B) = 1.73 us, lat(4 KB) = 2.46 us
#   slope = (2.46 - 1.73) / 4095 = 1.7827e-4 us/B
_RDMA_SLOPE = (2.46 - 1.73) / 4095.0

RDMA_CX6 = NetworkModel(
    name="rdma-cx6-100g",
    post_us=1.0,                 # Sec. 3.2: "posting an RDMA request ... ~1us"
    base_latency_us=1.73,        # Fig. 1 @ 1 B
    lat_per_byte_us=_RDMA_SLOPE,
    link_bw=12.5 * GB_PER_S,     # 100 Gbps
    inline_max=220,              # typical CX-6 max inline
)

HOST_X86 = HostModel(
    predicate_eval_us=0.35,
    slot_poll_us=0.008,          # one cache-line read + loop overhead
    upcall_us=0.60,
    upcall_batch_us=0.25,
    lock_us=0.15,
    memcpy_base_us=0.05,
    # Fig. 14: memcpy stays cheap to a few KB then deteriorates; a 10 KB
    # memcpy at ~12 GB/s of single-core copy bandwidth.
    memcpy_per_byte_us=1.0 / (12.0 * GB_PER_S),
)


# --- the device the port runs on -------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChipModel:
    """Compute-side constants used by the dry-run's roofline (the
    reference's, with the two link rates of a GPU cluster in place of one
    ICI link)."""

    name: str
    peak_flops: float       # FLOP/s, dense bf16 on the tensor cores
    hbm_bw: float           # bytes/s
    link_bw: float          # bytes/s a direction, between GPUs of a node
    hbm_bytes: float        # capacity
    node_size: int = 1      # GPUs a node share ``link_bw``
    inter_node_bw: float = 0.0   # bytes/s a GPU, between nodes

    def collective_bw(self, span: int) -> float:
        """The rate a collective runs at when its group spans ``span``
        consecutive devices: the node's links inside one node, the rate
        between nodes across more than one."""
        return self.link_bw if span <= self.node_size else self.inter_node_bw


# NVIDIA's datasheet for the H100 SXM5 80 GB (700 W): 989.4 TFLOP/s dense
# bf16, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s a GPU (450 GB/s a
# direction) inside an 8-GPU HGX node, one 400 Gb/s NDR port a GPU
# (50 GB/s) between nodes.
H100_SXM = ChipModel(
    name="h100-sxm",
    peak_flops=989.4e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
    node_size=8,
    inter_node_bw=50e9,
)


def axes_span(sizes: Dict[str, int], axes) -> int:
    """How many consecutive devices (row-major over ``sizes``, a mesh's
    ordered axis -> size) one group over ``axes`` spans."""
    names = list(sizes)
    span = 1
    for a in axes:
        i = names.index(a)
        stride = 1
        for b in names[i + 1:]:
            stride *= sizes[b]
        span += (sizes[a] - 1) * stride
    return span


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int, chip: ChipModel = H100_SXM,
                   link_bw: Optional[float] = None) -> dict:
    """The three roofline terms (seconds).

    compute    = FLOPs            / (chips * peak)
    memory     = HBM bytes        / (chips * hbm_bw)
    collective = collective_bytes / (chips * link_bw)

    ``flops``/``hbm_bytes``/``coll_bytes`` are *global* (whole-program)
    quantities; ``link_bw`` defaults to the chip's in-node rate."""
    bw = chip.link_bw if link_bw is None else link_bw
    compute = flops / (n_chips * chip.peak_flops)
    memory = hbm_bytes / (n_chips * chip.hbm_bw)
    collective = coll_bytes / (n_chips * bw)
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }
