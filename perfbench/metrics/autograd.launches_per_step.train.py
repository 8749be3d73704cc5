"""Device operations launched in the traced window per training step:
forward, the recomputed blocks of the backward, the backward, the clips,
Adam and the EMA."""


def read(run):
    if not run or not run["steps"] or not run["trace"].span_launches.get("window"):
        return None
    return run["trace"].span_launches["window"] / run["steps"]
