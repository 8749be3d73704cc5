"""Milliseconds a training step waited for its batch: the benchmark's
span around taking the prefetched batch and copying it to the card (a
synchronize ends it), per step of the traced window."""


def read(run):
    if not run or not run["steps"]:
        return None
    return run["data_s"] * 1e3 / run["steps"]
