"""Seconds the card's process waited for a system's features, per system
docked in the traced window, from the benchmark's own spans: the waits
for `dock_many`'s next loaded system (`load_wait`: one system at a time,
the in-process load of the first and the worker's result of the others),
else the in-process loads (`load`: the batched path loads every system in
process)."""


def read(run):
    if not run or not run["systems"]:
        return None
    host = run["spans"].host_s
    wait = host.get("load_wait", host.get("load"))
    return None if wait is None else wait / run["systems"]
