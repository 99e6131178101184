"""Dispatch between the hand-written kernels and their plain versions.

The route is decided by where the tensors lie, and nothing else: a CPU
tensor goes to the plain PyTorch version in ``kernels.ref``; a CUDA tensor
goes to the Hopper kernel, which raises on a shape or dtype it does not
take.  No shape ever sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_cuda
from repro_torch.kernels.paged_attention import \
    paged_decode_attention as _paged_cuda
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru_cuda


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Paged decode attention; shapes as in ``kernels.ref``."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                              seq_lens, window=window)
    return _paged_cuda(q, k_pages, v_pages, page_table, seq_lens,
                       window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Whole-sequence attention forward (exact-length prefill); shapes as
    in ``kernels.ref``.  The JAX router also asks for ``q_offset == 0`` and
    ``Sq, Skv >= 8``: the exact path always meets both (prompts are
    bucketed to at least 8 tokens), and the kernel raises otherwise."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash_cuda(q, k, v, causal=causal, window=window)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` (prefill of the
    recurrent layers); shapes as in ``kernels.ref``.  The JAX router sends
    only ``Dr % 128 == 0, S >= 8`` to its kernel; the CUDA kernel takes
    every S and every Dr that is a multiple of 4 (its TMA loads need
    16-byte rows), and raises on any other Dr: no shape is routed
    elsewhere.  recurrentgemma-9b serves at Dr = 4096."""
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    return _rglru_cuda(a, b, h0)
