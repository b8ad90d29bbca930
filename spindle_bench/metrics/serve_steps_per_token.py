"""The engines' model steps (prefill positions and decodes, as the
program counts them) per output token, over the window."""


def read(run):
    tokens = run.counters.get("tokens", 0)
    return run.counters["steps"] / tokens if tokens else None
