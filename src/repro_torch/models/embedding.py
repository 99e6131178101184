"""Token embedding and unembedding (counterpart of
``repro.models.embedding``; the token front end only)."""

from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """(..., S) integer tokens -> (..., S, D)."""
    x = params["tok"][tokens.long()].to(compute_dtype)
    if cfg.scale_embeddings:
        # a 0-dim CPU tensor acts as a scalar rounded to the compute dtype,
        # as the JAX package rounds it, with no host-to-device copy
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., D) -> (..., V) float32 logits (softcap applied if configured)."""
    table = params["tok"] if cfg.tie_embeddings else params["untok"]
    logits = (x @ table.to(x.dtype).t()).float()
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
