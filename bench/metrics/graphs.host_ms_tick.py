"""Host ms a decode call in the window: from the backend's ``decode`` being
called to its tokens being on the host (the inputs' copies, the sampler's
noise, the graph's replay and the wait for it).  Host clock around each
call."""


def read(run):
    calls = run.phase.decode
    if not calls:
        return None
    return 1e3 * sum(c.t1 - c.t0 for c in calls) / len(calls)
