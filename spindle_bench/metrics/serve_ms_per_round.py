"""Milliseconds of the window's wall per fused serve round."""


def read(run):
    rounds = run.counters.get("rounds", 0)
    return run.wall_s / rounds * 1e3 if rounds else None
