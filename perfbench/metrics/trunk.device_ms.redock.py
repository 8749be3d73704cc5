"""Device milliseconds of the operations launched inside the trunk's spans
(`PhysDock.conditioning`), per system docked in the traced window (every
round's trunk counted)."""


def read(run):
    if not run or not run["systems"] or not run["trace"].span_launches.get("trunk"):
        return None
    return run["trace"].span_device["trunk"]["all"] * 1e3 / run["systems"]
