"""Model FLOP utilisation of the window, in %, as ``mfu_decode`` computes
it; read in the prefill cells, where it moves with prompt tokens a
second."""

from bench import flops


def read(run):
    return flops.window_mfu(run)
