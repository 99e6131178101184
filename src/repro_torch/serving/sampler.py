"""Per-row token sampling: greedy / temperature / top-k / top-p
(counterpart of ``repro.serving.sampler``).

``jax.random`` keys cannot be carried into PyTorch, so the random draw is
taken out of the sampler: ``sample_batched`` takes its Gumbel noise as an
argument and returns ``argmax(truncated_logits / temp + noise)`` for
sampled rows — the categorical draw ``jax.random.categorical`` makes, with
the noise handed in.  ``gumbel_noise`` draws each row's noise from a
``torch.Generator`` seeded by ``token_seed(request_seed(seed, request_id),
token_idx)``: a function of ``(seed, request_id, token_idx)`` only, so a
request's stream does not depend on the microbatch layout or the order of
admission (the key discipline of ``repro.serving.sampler``).

Row semantics, as in the JAX package:
  - ``temp[i] <= 0``  → greedy: ``argmax`` of the raw logits;
  - ``top_k[i] <= 0`` → no top-k truncation;
  - ``top_p[i] >= 1`` → no nucleus truncation;
  - ties at the top-k / top-p cutoff are kept (the mask is
    ``logits < cutoff``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_seed(seed: int, request_id: int) -> int:
    """Per-request base seed, a function of (seed, request_id) only."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (request_id & _MASK64)) \
        >> 1


def token_seed(base: int, token_idx: int) -> int:
    """Per-token seed from a request's base seed (63 bits, so it fits the
    generator's signed seed)."""
    return _splitmix64(base ^ _splitmix64(token_idx & _MASK64)) >> 1


@dataclass
class RowSampling:
    """Per-row sampling state for one microbatch tick (host numpy).  The
    engine slices these out of its per-slot arrays."""
    keys: np.ndarray                  # (mb,) int64 per-request base seeds
    steps: np.ndarray                 # (mb,) int32 token index being sampled
    temp: np.ndarray                  # (mb,) float32
    top_k: np.ndarray                 # (mb,) int32
    top_p: np.ndarray                 # (mb,) float32

    @property
    def any_sampled(self) -> bool:
        return bool((self.temp > 0).any())


def gumbel_noise(samp: RowSampling, vocab: int, device,
                 gen: torch.Generator, out=None) -> torch.Tensor:
    """(mb, V) float32 standard Gumbel noise: row ``i`` drawn from ``gen``
    reseeded with ``token_seed(keys[i], steps[i])``; greedy rows get zeros
    (their draw is never used).  With ``out`` (a captured decode step's
    static noise tensor) the noise is written there and ``out`` returned."""
    if out is None:
        noise = torch.zeros((len(samp.temp), vocab), dtype=torch.float32,
                            device=device)
    else:
        noise = out.zero_()
    tiny = torch.finfo(torch.float32).tiny
    for i in np.flatnonzero(samp.temp > 0):
        gen.manual_seed(token_seed(int(samp.keys[i]), int(samp.steps[i])))
        u = torch.rand((vocab,), generator=gen, dtype=torch.float32,
                       device=device)
        noise[i] = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return noise


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def sample_batched(logits: torch.Tensor, gumbel: torch.Tensor,
                   temp: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Sample one token per row under per-row params.

    logits (B, V) float32; gumbel (B, V) float32 noise; temp/top_p (B,)
    float32; top_k (B,) int.  Returns (B,) int32 tokens.  Truncation is
    the sorted path of the JAX package (``_sorted_path``): one descending
    sort serves both the top-k cutoff and the nucleus pass."""
    B, V = logits.shape
    is_greedy = temp <= 0.0
    x = logits / torch.where(is_greedy, 1.0, temp)[:, None]
    sorted_desc = x.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    k_on = (top_k > 0)[:, None]
    neg_inf = float("-inf")
    x = torch.where(k_on & (x < kth), neg_inf, x)
    sorted_desc = torch.where(k_on & (sorted_desc < kth), neg_inf, sorted_desc)
    # top-p: keep the smallest prefix with cumulative prob >= p (>= 1 token)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]
    cutoff = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1,
                                                               keepdim=True)
    x = torch.where(x < cutoff, neg_inf, x)
    sampled = (x + gumbel).argmax(dim=-1)
    return torch.where(is_greedy, logits.argmax(dim=-1), sampled).to(
        torch.int32)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probability of ``tokens`` (B,) under the model distribution (raw
    logits, before any temperature / truncation)."""
    lp = torch.log_softmax(logits, dim=-1)
    return lp.gather(1, tokens.long()[:, None])[:, 0]
