"""The yardstick: the H100's published rates, the paged decode kernel's
bytes and operations, and a model's operations a token.

The kernel arithmetic is a frozen copy of ``repro_torch.kernels.cost``
(``paged_cost``, ``least_ms``, the rates) taken when the benchmark was
written, so that a change to the program cannot move the measure it is
judged by.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

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


def matmul_params(s: Dict[str, int]) -> Dict[str, int]:
    """Parameters that a token multiplies through: ``layers`` (every
    layer's projections and the FFN a token uses: its top-k experts and
    the router on a sparse model) and ``head`` (the unembedding)."""
    D, H, Hk, Dh, F = s["D"], s["H"], s["Hk"], s["Dh"], s["F"]
    attn = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D
    ffn = s["K"] * 3 * D * F + D * s["E"] if s["E"] else 3 * D * F
    return {"layers": s["L"] * (attn + ffn), "head": D * s["V"]}


def token_flops(s: Dict[str, int], tokens: int, ctx_sum: int,
                head_rows: int) -> float:
    """Model operations of ``tokens`` real tokens whose attended lengths
    sum to ``ctx_sum`` (a token at position ``p`` attends ``p + 1``), with
    ``head_rows`` rows through the unembedding: two a multiply-add over
    the layers' parameters, ``4 * H * Dh`` a token attended a layer, two
    a head parameter a row."""
    p = matmul_params(s)
    return (2.0 * p["layers"] * tokens
            + 4.0 * s["H"] * s["Dh"] * s["L"] * ctx_sum
            + 2.0 * p["head"] * head_rows)


def window_mfu(run) -> float:
    """The window's model operations over its seconds times the bf16 peak a
    card, in %: every real token of the decode calls (live rows, at their
    lengths, each through the head) and of the prefill calls (real tokens,
    causal lengths, each chunk row through the head)."""
    ph, s = run.phase, run.sizes
    toks = sum(c.live for c in ph.decode) + sum(c.live for c in ph.prefill)
    ctx = sum(c.ctx for c in ph.decode) + sum(c.ctx for c in ph.prefill)
    head = sum(c.live for c in ph.decode) + sum(c.rows for c in ph.prefill)
    ops = token_flops(s, toks, ctx, head)
    peak = PEAK_FLOPS[run.dtype_name] * run.cards
    return 100.0 * ops / (ph.seconds * peak)
