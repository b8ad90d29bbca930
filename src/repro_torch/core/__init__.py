"""Protocol core of the port: SST arithmetic, SMC ring, null-send rule,
delivery predicate, the fused sweep, the discrete-event simulator of the
paper's testbed (``simulator``, ``desgraph``, ``desreplay``), the Group
API, DDS topics, the Spindle gradient reductions and the ranks they run
across."""

from repro_torch.core import (costmodel, dds, delivery, desgraph, desreplay,
                              gradsync, group, nullsend, ranks, simulator,
                              smc, sst, sweep, views)

__all__ = ["costmodel", "dds", "delivery", "desgraph", "desreplay",
           "gradsync", "group", "nullsend", "ranks", "simulator", "smc",
           "sst", "sweep", "views"]
