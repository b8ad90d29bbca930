"""Device operations per protocol round in the traced segment."""


def read(run):
    if run.trace is None or not run.trace["counters"].get("rounds"):
        return None
    return run.trace["device_ops"] / run.trace["counters"]["rounds"]
