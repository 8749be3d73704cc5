"""The training window's share of the card's dense bf16 peak: three times
the analytic forward FLOPs of every system the window trained on
(forward, and a backward of twice the forward; the recomputation of
checkpointed blocks not counted), at each system's real token, atom and
MSA-row counts, over the window's length and the peak."""


def read(run):
    if not run or not run["peak_flops"] or not run["flops"]:
        return None
    return 100.0 * run["flops"] / run["trace"].window_s / run["peak_flops"]
