"""Device milliseconds of the operations launched inside the sampler's
spans and outside its guidance spans, per reverse step."""


def read(run):
    if not run or not run["steps"] or not run["trace"].span_launches.get("sampler"):
        return None
    return run["trace"].span_device["sampler"]["minus:guidance"] * 1e3 / run["steps"]
