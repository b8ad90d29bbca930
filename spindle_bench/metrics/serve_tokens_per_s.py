"""Output tokens of the batches the window completed, over its wall."""


def read(run):
    return run.counters["tokens"] / run.wall_s
