"""Token embedding, the stub audio and vision front ends, and the
unembedding (counterpart of ``repro.models.embedding``).

The ``[audio]`` / ``[vlm]`` archs specify the transformer backbone only:
their front end takes precomputed frame / patch embeddings and projects
them into the residual stream with one ``(D, D)`` matrix.
"""

from __future__ import annotations

import math
from typing import Optional

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


def embed_frames(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Audio stub: precomputed EnCodec frame embeddings (B, S, D_in) are
    projected into the residual stream -> (B, S, D)."""
    return frames.to(compute_dtype) @ params["frame_proj"].to(compute_dtype)


def embed_patches(params: dict, patches: torch.Tensor, cfg: ModelConfig,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """Vision stub: precomputed merged-patch embeddings (B, P, D_in)
    projected into the residual stream (qwen2-vl's ``merger``, one layer
    here) -> (B, P, D)."""
    return patches.to(compute_dtype) @ params["patch_proj"].to(compute_dtype)


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., D) -> (..., V) float32 logits (softcap applied if configured).
    ``table`` is the head's table where it is not in ``params``: a tied
    model's copy of ``"tok"`` on the last pipeline stage's device
    (``models.model.tied_head``)."""
    if table is None:
        table = params["tok"] if cfg.tie_embeddings else params["untok"]
    logits = (x @ table.to(x.dtype).t()).float()
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
