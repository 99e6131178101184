"""Model FLOP utilisation of the window, in %: the operations of every
real token prefilled or decoded (the configuration's ``window_ops``, in
``bench/reference/<name>.py``) over the window's seconds times 989 TFLOP/s
a card.  Moves with generated tokens a second in the decode cells."""

from bench import flops


def read(run):
    return flops.window_mfu(run)
