"""Application messages delivered at every member, over the window's
wall: every round the window's calls streamed, the loads of their
arrivals and the reads of their per-round matrices included."""


def read(run):
    return run.counters["delivered"] / run.wall_s
