"""Milliseconds the card sat idle inside the guidance spans (conformer
matching, force-field relaxation, rigid alignment, chirality checks and
building the guidance), per system docked in the traced window: each idle
gap counts where its middle lies."""


def read(run):
    if not run or not run["systems"]:
        return None
    idle = run["trace"].idle_s_by_span.get("guidance")
    return None if idle is None else idle * 1e3 / run["systems"]
