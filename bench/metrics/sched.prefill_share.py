"""Share of the window the engine spent in its prefill phase, in %
(``EngineStats.prefill_time_s``: the phase ends with the card synchronised,
so it holds the chunk's device time)."""


def read(run):
    ph = run.phase
    return 100.0 * ph.delta("prefill_time_s") / ph.seconds
