"""The benchmark's frozen yardstick: traffic generation, the chip's
peaks, and the operation and byte counts of the metrics.  Later changes
to the program cannot move it."""
