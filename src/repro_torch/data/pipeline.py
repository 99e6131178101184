"""Synthetic-token data pipeline (own copy of ``repro.data.pipeline``, numpy
only): deterministic generation, document packing, sharded per-host
loading.  Its batches equal the JAX package's bit for bit.

The framework trains on language-model token streams; without a licensed
corpus in the container we generate a *structured* synthetic stream (Zipfian
unigrams + a repeated-bigram process) — enough signal that the training loss
drops measurably, which the integration tests assert.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int                   # per-host batch
    accum_steps: int = 1
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 128
    bigram_repeat_p: float = 0.6      # P(copy a previously seen bigram)


class SyntheticTokens:
    """Deterministic document stream with learnable local structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        # fixed random bigram table: next(token) is predictable 60% of time
        self._next = self.rng.randint(1, cfg.vocab_size,
                                      size=(cfg.vocab_size,))

    def document(self) -> np.ndarray:
        c = self.cfg
        n = max(2, int(self.rng.exponential(c.mean_doc_len)))
        toks = np.empty((n,), np.int64)
        toks[0] = 1 + self.rng.zipf(c.zipf_a) % (c.vocab_size - 1)
        for i in range(1, n):
            if self.rng.rand() < c.bigram_repeat_p:
                toks[i] = self._next[toks[i - 1]]
            else:
                toks[i] = 1 + self.rng.zipf(c.zipf_a) % (c.vocab_size - 1)
        return toks

    def packed_stream(self) -> Iterator[np.ndarray]:
        """Pack documents into fixed seq_len rows, 0 as separator."""
        c = self.cfg
        buf = np.empty((0,), np.int64)
        while True:
            while buf.size < c.seq_len + 1:
                buf = np.concatenate([buf, [0], self.document()])
            yield buf[: c.seq_len + 1].copy()
            buf = buf[c.seq_len:]


def batches(cfg: DataConfig, *, host_index: int = 0,
            host_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Yield {"tokens","labels","loss_mask"} batches, disjoint across hosts
    (host h consumes rows h, h+H, h+2H, ... of the global stream)."""
    stream_cfg = dataclasses.replace(cfg, seed=cfg.seed)
    rows = SyntheticTokens(stream_cfg).packed_stream()

    def one_batch():
        out = np.empty((cfg.batch_size, cfg.seq_len + 1), np.int64)
        got = 0
        i = 0
        while got < cfg.batch_size:
            row = next(rows)
            if i % host_count == host_index:
                out[got] = row
                got += 1
            i += 1
        tokens = out[:, :-1].astype(np.int32)
        labels = out[:, 1:].astype(np.int32)
        mask = (labels != 0).astype(np.float32)
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    while True:
        if cfg.accum_steps > 1:
            bs = [one_batch() for _ in range(cfg.accum_steps)]
            yield {k: np.stack([b[k] for b in bs]) for k in bs[0]}
        else:
            yield one_batch()
