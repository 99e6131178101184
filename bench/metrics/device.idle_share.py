"""Share of the traced slice in which no device operation ran, in %, the
mean over the cell's cards.  From the profiler's trace."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.ops or tl.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tl.mean_busy_s(run.cards) / tl.window_s)
