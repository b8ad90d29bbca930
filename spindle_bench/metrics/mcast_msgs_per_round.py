"""Messages delivered at every member per protocol round (the batching
of the sst/sweep layer), over the window."""


def read(run):
    rounds = run.counters.get("rounds", 0)
    return run.counters["delivered"] / rounds if rounds else None
