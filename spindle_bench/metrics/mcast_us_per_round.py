"""Microseconds of the window's wall per protocol round streamed."""


def read(run):
    rounds = run.counters.get("rounds", 0)
    return run.wall_s / rounds * 1e6 if rounds else None
