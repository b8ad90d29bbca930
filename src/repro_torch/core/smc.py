"""SMC — the small-message multicast ring buffer (paper Sec. 2.3).

Each (subgroup, sender) owns ``w`` fixed-size slots.  A slot is
``(message area, counter)``; the counter's increment signals a fresh
message.  Message index ``k`` lives in slot ``k % w`` and bumps that
slot's counter to ``k // w`` (counters start at -1 == unused).

A slot may be reused only once *every* member has delivered the message it
holds, so sender ``s`` may publish index ``k`` iff ``k < delivered_s + w``.

Total SMC memory per subgroup (Sec. 4.1.2): ``n * w * (m + 8)`` bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    window: int = 100            # w; Sec. 4.1.2 recommends ~100 for 10 KB
    max_msg_size: int = 10240    # slot message area, bytes
    slot_overhead: int = 8       # the slot counter

    @property
    def slot_bytes(self) -> int:
        return self.max_msg_size + self.slot_overhead

    def region_bytes(self, n_nodes: int) -> int:
        """Total pinned SMC memory for one subgroup (n * w * (m + 8))."""
        return n_nodes * self.window * self.slot_bytes


# --- slot arithmetic --------------------------------------------------------

def slot_of(index, window: int):
    return index % window


def counter_for(index, window: int):
    """Counter value a slot holds after message `index` is written to it."""
    return index // window


def publish_cap(delivered_count, window: int):
    """Highest publishable index+1 for a sender given the minimum number of
    its messages delivered across all members."""
    return delivered_count + window


def free_slots(published_count, delivered_count, window: int):
    """How many more messages the sender may publish right now."""
    return publish_cap(delivered_count, window) - published_count


def visible_from_counters(counters: torch.Tensor, received_count: torch.Tensor,
                          window: int) -> torch.Tensor:
    """Contiguous-scan of a sender's slot counters (the receive predicate):
    starting from ``received_count``, walk forward while the expected slot
    counter is present.

    counters: (..., w); received_count: (...,) -> new visible count (...,),
    in ``counters``' dtype.  Message index k is visible iff
    ``counters[k % w] >= k // w``; the result is the longest contiguous run
    starting at received_count, capped at one full window ahead.
    """
    ks = received_count[..., None] + torch.arange(
        window, device=counters.device, dtype=received_count.dtype)
    slots = (ks % window).long()        # take_along_dim indexes with int64
    have = torch.take_along_dim(counters, slots, dim=-1) >= ks // window
    run = torch.cumprod(have.to(counters.dtype), dim=-1, dtype=counters.dtype)
    return received_count + run.sum(dim=-1, dtype=counters.dtype)


# --- functional publish over an SST table -----------------------------------

def publish(table: Dict[str, torch.Tensor], node: int, subgroup: int,
            new_count: int, window: int) -> Dict[str, torch.Tensor]:
    """Write messages [old_count, new_count) into the ring: bump slot
    counters and the published watermark on the node's own row.
    Functional (returns a new table; the input is not modified).

    ``table["slot_counter"]``: (n_nodes, n_subgroups, window) int32;
    ``table["published_num"]``: (n_nodes, n_subgroups) int32 seq
    watermark (-1 = nothing published).  ``new_count`` is the total number
    of messages published after this call.  This builds the explicit ring
    that :func:`repro_torch.kernels.smc_sweep.smc_sweep` reads.
    """
    counters = table["slot_counter"]
    old = table["published_num"][node, subgroup] + 1      # count published
    # the last W indexes before new_count cover every slot once; those at
    # or past `old` are this call's writes (the later of two writes to one
    # slot wins, as in a message-by-message publish)
    ks = (new_count - window) + torch.arange(
        window, device=counters.device, dtype=counters.dtype)
    slots = ks % window
    vals = torch.where(ks >= old, ks // window,
                       counters[node, subgroup, slots])
    counters = counters.clone()
    counters[node, subgroup, slots] = vals
    published = table["published_num"].clone()
    published[node, subgroup] = torch.clamp(published[node, subgroup],
                                            min=new_count - 1)
    return dict(table, slot_counter=counters, published_num=published)
