"""The one traffic generator: a mix file's parameters in, requests out.

A mix fixes a *deck* of ``deck`` requests, the same for every seed: prompt
and output lengths at evenly spaced quantiles of the mix's distributions.
The deck is cut into ``block`` strata of prompt lengths (``deck / block``
cards each, shortest first) and as many of output lengths, and card ``r``
of prompt stratum ``s`` takes the ``r``-th output of output stratum ``(s +
r) mod block``; so block ``r`` (card ``r`` of every prompt stratum) holds
one prompt and one output of every stratum, and half of it is sampled.
The seed orders each pass through the deck: the blocks, and the cards
inside each block, and draws the prompts' token ids.  Every stretch of
``block`` requests then carries nearly the same work, and a window sees
nearly the same mix whatever the seed, so runs of different seeds spread
no wider than runs of one seed.

The first ``rows`` requests of a stream (the first batch-full) take their
output lengths from the mix's *residual-life* distribution instead, at
its evenly spaced quantiles in the seed's order: in a steady closed loop a
slot picked at random holds a request whose remaining output ``r`` has
probability proportional to ``P(L >= r)``.  So the first batch ends at
staggered times, as a batch in steady state does, and the measured window
opens without waiting one request's lifetime.

Mix file keys: ``deck`` and ``block`` (``deck`` a multiple of ``block``,
which is even);
``prompt`` and ``output``, each ``{"kind": "log_uniform" | "uniform",
"lo", "hi"}`` (tokens, both ends included); ``sampled_share`` (0 or 0.5:
the cards of odd ``s + r`` are sampled); ``temperature``, ``top_p``,
``top_k`` (the sampled requests'); ``backlog`` (requests kept queued
beyond the running batch: an integer, or ``"rows"`` for as many as the
batch has rows).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

SEED_MOD = 1 << 64


@dataclass
class Req:
    """One generated request: prompt token ids, tokens to generate, and
    whether it is greedy (else sampled with the mix's settings)."""
    index: int
    prompt: np.ndarray
    max_new: int
    greedy: bool


def _quantile(dist: dict, q: np.ndarray) -> np.ndarray:
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["kind"] == "log_uniform":
        x = lo * (hi / lo) ** q
    elif dist["kind"] == "uniform":
        x = lo + (hi - lo) * q
    else:
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def deck(mix: dict) -> List[tuple]:
    """The mix's ``(prompt_len, output_len, greedy)`` cards, block by block
    (independent of any seed)."""
    n, b = int(mix["deck"]), int(mix.get("block", 8))
    share = float(mix["sampled_share"])
    if n % b or b % 2 or share not in (0.0, 0.5):
        raise ValueError("deck must be a multiple of an even block, and "
                         "sampled_share 0 or 0.5")
    m = n // b
    q = (np.arange(n) + 0.5) / n
    prompts = _quantile(mix["prompt"], q)
    outputs = _quantile(mix["output"], q)
    cards = []
    for r in range(m):
        for s in range(b):
            sampled = share > 0 and (s + r) % 2 == 1
            cards.append((int(prompts[s * m + r]),
                          int(outputs[((s + r) % b) * m + r]), not sampled))
    return cards


def residual_pmf(lengths: List[int]) -> np.ndarray:
    """``pmf[r - 1]`` for ``r = 1 .. max(lengths)``: proportional to the
    share of ``lengths`` at least ``r``."""
    lengths = np.asarray(lengths)
    r = np.arange(1, int(lengths.max()) + 1)
    surv = (lengths[None, :] >= r[:, None]).mean(axis=1)
    return surv / surv.sum()


class Stream:
    """The requests of one run: ``next()`` gives the next, forever.

    The first request is greedy whatever the order, so that a run's first
    decode tick (one live row) is the all-greedy step, and the harness
    warms up both decode steps before its window."""

    def __init__(self, mix: dict, seed: int, vocab: int, rows: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.rows = int(rows)
        self.rng = np.random.default_rng(int(seed) % SEED_MOD)
        self.cards = deck(mix)
        self.block = int(mix.get("block", 8))
        pmf = residual_pmf([c[1] for c in self.cards])
        cdf = np.cumsum(pmf)
        q = (np.arange(self.rows) + 0.5) / self.rows
        lives = np.searchsorted(cdf, q) + 1
        self.residual = list(lives[self.rng.permutation(self.rows)])
        self.order: List[int] = []
        self.count = 0

    def _next_card(self) -> tuple:
        if not self.order:
            b = self.block
            order = [blk * b + int(j)
                     for blk in self.rng.permutation(len(self.cards) // b)
                     for j in self.rng.permutation(b)]
            if self.count == 0:
                first = next(i for i, j in enumerate(order)
                             if self.cards[j][2])
                order[0], order[first] = order[first], order[0]
            self.order = order
        return self.cards[self.order.pop(0)]

    def next(self) -> Req:
        plen, out, greedy = self._next_card()
        if self.count < self.rows:
            out = int(self.residual[self.count])
        prompt = self.rng.integers(0, self.vocab, size=plen, dtype=np.int64)
        req = Req(self.count, prompt.astype(np.int32), out, greedy)
        self.count += 1
        return req

    def backlog(self) -> int:
        b = self.mix.get("backlog", "rows")
        return self.rows if b == "rows" else int(b)


def max_context(mix: dict) -> int:
    """The most positions a request of the mix holds: its longest prompt
    and its longest output."""
    return int(mix["prompt"]["hi"]) + int(mix["output"]["hi"])


def pages_for(mix: dict, page_size: int) -> int:
    return int(math.ceil(max_context(mix) / page_size))
