"""Prompt tokens a second: real prompt tokens prefilled inside the window
(pad positions of a chunk are not counted), over the window's seconds.
Host clock between two synchronisations."""


def read(run):
    ph = run.phase
    return ph.delta("prefill_tokens") / ph.seconds
