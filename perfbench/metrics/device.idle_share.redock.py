"""Share of the traced window in which no operation ran on the card."""


def read(run):
    if not run or not run["trace"].window_s:
        return None
    t = run["trace"]
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
