"""The whole window's share of the card's dense bf16 peak: the analytic
FLOPs of every system and round docked in the traced window
(`perfbench/flops`, at each system's real token, atom and MSA-row counts)
over the window's length and the peak."""


def read(run):
    if not run or not run["peak_flops"] or not run["flops"]:
        return None
    return 100.0 * run["flops"] / run["trace"].window_s / run["peak_flops"]
