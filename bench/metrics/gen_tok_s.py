"""Generated tokens a second: every token the engine emitted inside the
window (first tokens sampled at the end of a prefill included), over the
window's seconds.  Host clock between two synchronisations."""


def read(run):
    ph = run.phase
    return ph.delta("decode_tokens") / ph.seconds
