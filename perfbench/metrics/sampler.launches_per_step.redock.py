"""Device operations launched inside the sampler's spans per reverse step
(one denoiser call, over every system of the pass), guidance included."""


def read(run):
    if not run or not run["steps"] or not run["trace"].span_launches.get("sampler"):
        return None
    return run["trace"].span_launches["sampler"] / run["steps"]
