"""The work of each hand-written kernel, and the H100's rates: the one home
of both.

The dry run (``launch.dryrun``) reads a kernel's flops and bytes from the
formulas here, because a hand-written kernel is no aten op and
``torch.utils.flop_counter.FlopCounterMode`` does not see it; and
``chip_smoke.py`` computes each kernel's least time (its ``bound_ms``)
from the same formulas.  Bytes count each input read once and each output
written once; flops count the useful products (two a multiply-add) of the
live work, which depends on the call's lengths, window and mask where the
kernel's does.

``record`` books a kernel call with every counter that is open
(``counting``): the kernel routes of ``kernels.ops`` call it on the meta
route (the dry run's trace) and on the CUDA route (the dry run's check
on the card), so both count the same work.  With no counter open it
returns at once.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional, Tuple

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12             # HBM3
HBM_BYTES = 80e9                      # 80 GB
NVLINK_BYTES_PER_S = 450e9            # each way, to each other card
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16 / fp16
              "float16": 989e12,
              "float32": 67e12}       # float32 outside the tensor cores


def _series(lo: int, hi: int, c: int, s: int) -> int:
    """sum of ``max(0, c + s*i)`` for ``i`` in ``[lo, hi)``, ``s`` in
    {-1, 0, 1}: the positive run of a linear piece, as one arithmetic
    series."""
    if s == 0:
        return max(0, hi - lo) * max(0, c)
    if s > 0:
        lo = max(lo, 1 - c)           # c + i > 0
    else:
        hi = min(hi, c)               # c - i > 0
    n = hi - lo
    if n <= 0:
        return 0
    return n * c + s * n * (lo + hi - 1) // 2


def live_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a query sees, summed over the ``sq`` queries:
    query ``i`` sees keys ``max(0, i - window + 1) .. min(i, skv - 1)``
    (causal) or ``.. skv - 1`` (not), no lower edge without a window.  In
    closed form: the count a query is linear in ``i`` between the
    breakpoints ``skv`` and ``window``, so the total is at most three
    arithmetic series."""
    cuts = sorted({0, sq} | {b for b in (skv, window) if 0 < b < sq})
    total = 0
    for lo, hi in zip(cuts, cuts[1:]):
        # on [lo, hi): top = i (causal, i < skv) or skv - 1; bottom = 0
        # (no window, or i < window) or i - window + 1
        top_c, top_s = (0, 1) if causal and lo < skv else (skv - 1, 0)
        bot_c, bot_s = (0, 0) if window <= 0 or lo < window else \
            (1 - window, 1)
        total += _series(lo, hi, top_c - bot_c + 1, top_s - bot_s)
    return total


def flash_cost(b: int, sq: int, skv: int, h: int, hk: int, dh: int,
               causal: bool, window: int, esize: int,
               lse: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one flash-attention forward: ``4 * Dh`` flops a
    live (query, key) pair and head (the scores and P.V); q, k, v read and
    the output written once, and each score row's float32 log-sum-exp
    when asked."""
    flops = 4 * dh * h * live_pairs(sq, skv, causal, window) * b
    nbytes = (2 * sq * h * dh + 2 * skv * hk * dh) * esize * b
    if lse:
        nbytes += b * h * sq * 4
    return flops, nbytes


def scan_cost(b: int, s: int, dr: int, h0: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one RG-LRU scan, float32: a multiply and an add a
    step and channel; a and b read, every h_t written (12 bytes a step and
    channel), and h0 read when given."""
    return 2 * b * s * dr, 12 * b * s * dr + (4 * b * dr if h0 else 0)


def paged_cost(case_lens: Iterable[int], window: int, h: int, hk: int,
               dh: int, esize: int, b: int,
               max_pages: int) -> Tuple[int, int]:
    """(flops, bytes) of one paged decode attention: K and V rows each read
    once for the tokens attended (the work depends on the rows' lengths),
    q, the table and the lengths read once, the output written once;
    ``4 * H * Dh`` flops a token."""
    toks = sum(min(int(n), window) if window else int(n) for n in case_lens)
    nbytes = toks * hk * dh * 2 * esize + 2 * b * h * dh * esize \
        + b * max_pages * 4 + b * 4
    return 4 * h * dh * toks, nbytes


def chunk_cost(q_pos: Iterable[Iterable[int]], h: int, hk: int, dh: int,
               esize: int, max_pages: int, page: int) -> Tuple[int, int]:
    """(flops, bytes) of one chunked-prefill attention over a paged pool,
    ``q_pos`` each row's query positions (-1 padded): ``4 * H * Dh`` flops
    a (real query, visible key) pair, a real query at position ``p``
    seeing ``min(p + 1, T)`` slots of a ``T = max_pages * page`` table; a
    padded query's mean of V, ``2 * H * Dh`` flops a slot of the whole
    table.  Bytes: q and the output once; each row's K rows once up to its
    last real position and its V rows once up to that or, with a padded
    query, the whole table; the table and the positions once."""
    t = max_pages * page
    flops = nbytes = 0
    for row in q_pos:
        row = [int(p) for p in row]
        real = [min(p + 1, t) for p in row if p >= 0]
        pads = len(row) - len(real)
        flops += 4 * h * dh * sum(real) + 2 * h * dh * t * pads
        k_rows = max(real, default=0)
        v_rows = t if pads else k_rows
        nbytes += (k_rows + v_rows) * hk * dh * esize \
            + 2 * len(row) * h * dh * esize + max_pages * 4 + len(row) * 4
    return flops, nbytes


def least_ms(flops: float, nbytes: float, dtype_name: str) -> Tuple[float,
                                                                    str]:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the flops over the peak rate of the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------


class KernelCount:
    """Kernel calls booked while open: flops and bytes summed, calls by
    kernel name."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.calls: dict = {}

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.calls[name] = self.calls.get(name, 0) + 1


_OPEN: List[KernelCount] = []


@contextlib.contextmanager
def counting(count: Optional[KernelCount] = None):
    """Book every kernel call made inside the block with ``count`` (a new
    ``KernelCount`` when None), which it yields."""
    count = KernelCount() if count is None else count
    _OPEN.append(count)
    try:
        yield count
    finally:
        _OPEN.remove(count)


def record(name: str, flops: int, nbytes: int) -> None:
    """Book one kernel call with every open counter."""
    for count in _OPEN:
        count.add(name, flops, nbytes)


def record_flash(q, k, causal: bool, window: int, lse: bool) -> None:
    """Book a flash-attention call of q (B, Sq, H, Dh), k (B, Skv, Hk, Dh)."""
    if _OPEN:
        b, sq, h, dh = q.shape
        record("flash_attention", *flash_cost(
            b, sq, k.shape[1], h, k.shape[2], dh, causal, window,
            q.element_size(), lse))


def record_scan(a, h0) -> None:
    """Book an RG-LRU scan of a (B, S, Dr)."""
    if _OPEN:
        record("rglru_scan", *scan_cost(*a.shape, h0=h0 is not None))
