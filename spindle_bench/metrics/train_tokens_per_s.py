"""Tokens trained over the window's wall, across all ranks of the cell."""


def read(run):
    return run.counters["tokens"] / run.wall_s
