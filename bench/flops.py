"""The yardstick: the H100's published rates, the paged decode kernel's
bytes and operations, the lengths a window's tokens attend, and the
window's model FLOP utilisation.

The kernel arithmetic is a frozen copy of ``repro_torch.kernels.cost``
(``paged_cost``, ``least_s``, the rates) taken when the benchmark was
written, so that a change to the program cannot move the measure it is
judged by.  Each architecture's operations a token are kept with its
plain reference, in ``bench/reference/<name>.py`` (``window_ops``).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def paged_cost(case_lens: Iterable[int], window: int, h: int, hk: int,
               dh: int, esize: int, b: int,
               max_pages: int) -> Tuple[int, int]:
    """(flops, bytes) of one paged decode attention over ``b`` rows of the
    given lengths: each K and V row read once for the tokens attended, q,
    the table and the lengths read once, the output written once; ``4 * H
    * Dh`` flops a token."""
    toks = sum(min(int(n), window) if window else int(n) for n in case_lens)
    nbytes = toks * hk * dh * 2 * esize + 2 * b * h * dh * esize \
        + b * max_pages * 4 + b * 4
    return 4 * h * dh * toks, nbytes


def least_s(flops: float, nbytes: float, dtype_name: str) -> float:
    """The least seconds: the larger of the bytes over the memory rate and
    the flops over the dtype's peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name])


def attended(offsets, n_valid, window: int = 0) -> int:
    """The lengths attended, summed over the real tokens of a call's rows
    (a ``Call``'s ``offsets`` and ``n_valid``): a token at position ``p``
    attends ``p + 1`` positions, at most ``window`` where ``window > 0``."""
    o = np.asarray(offsets, np.int64)
    n = np.asarray(n_valid, np.int64)
    if window <= 0:
        return int((n * o + n * (n + 1) // 2).sum())
    m = np.clip(window - o, 0, n)           # tokens below the window's cap
    return int((m * o + m * (m + 1) // 2 + (n - m) * window).sum())


def window_mfu(run) -> float:
    """The window's model operations (the configuration's module's
    ``window_ops``) over its seconds times the bf16 peak a card, in %."""
    ops = run.arch.window_ops(run.sizes, run.phase)
    peak = PEAK_FLOPS[run.dtype_name] * run.cards
    return 100.0 * ops / (run.phase.seconds * peak)
