"""Protocol core of the port: SST arithmetic, SMC ring, null-send rule,
delivery predicate, the fused sweep, the Group API, DDS topics and the
Spindle gradient reductions."""
