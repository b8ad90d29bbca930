"""Shares of the device's time read from the traced segment."""


def idle_percent(run):
    """The share of a call's untraced wall with no operation on the
    device, in percent: the device's busy seconds a call in the traced
    segment (the profiler times each operation on the device itself)
    over the window's wall a call.  The traced segment's own wall is not
    used: the profiler slows a call's host side, about five times over
    for a fused serve call."""
    if run.trace is None or not run.calls:
        return None
    busy = run.trace["busy_s"] / run.traffic["trace_calls"]
    return 100.0 * (1.0 - busy / (run.wall_s / run.calls))


def op_seconds(trace, *keys):
    """(launches, seconds) of the device operations whose name holds any
    of ``keys``."""
    n, s = 0, 0.0
    for name, (count, sec) in trace["ops"].items():
        if any(k in name for k in keys):
            n += count
            s += sec
    return n, s
