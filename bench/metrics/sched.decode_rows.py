"""Live rows a decode tick: rows with a decoding request in each decode
call of the window, averaged (the scheduler's batch occupancy).  Counted by
the harness's wrapper around the backend's ``decode``."""


def read(run):
    calls = run.phase.decode
    if not calls:
        return None
    return sum(c.live for c in calls) / len(calls)
