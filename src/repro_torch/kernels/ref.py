"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.  The router (``kernels.ops``)
never takes them for a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.attention import chunk_attention

NEG_INF = -1e30


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               seq_lens: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """Gather-then-attend paged decode attention.

    q          (B, H, Dh)         current-token queries
    k/v_pages  (P, page, Hk, Dh)  shared page pool
    page_table (B, max_pages)     page ids per sequence, row-major in time
    seq_lens   (B,)               tokens present per sequence
    -> (B, H, Dh) in q's dtype, float32 arithmetic.

    Computes what ``repro.kernels.paged_attention.paged_decode_attention``
    computes: the softmax over the row's tokens ``[max(len - window, 0),
    len)`` (all of ``[0, len)`` without a window), page ids clamped to the
    pool.  Slots outside that range are replaced by zeros before any
    arithmetic, so whatever they hold (another request's KV, NaN) cannot
    reach the output, and a ``seq_len == 0`` row is exact zeros.
    """
    b, h, dh = q.shape
    n_pool, page_size, hk, _ = k_pages.shape
    g = h // hk
    c = page_table.shape[1] * page_size
    pt = page_table.long().clamp(0, n_pool - 1)
    k = k_pages[pt].reshape(b, c, hk, dh)
    v = v_pages[pt].reshape(b, c, hk, dh)
    pos = torch.arange(c, device=q.device)[None]              # (1, C)
    lens = seq_lens.long()[:, None]                           # (B, 1)
    valid = pos < lens
    if window > 0:
        valid &= pos >= lens - window
    keep = valid[:, :, None, None]
    k = torch.where(keep, k, 0).float()
    v = torch.where(keep, v, 0).float()
    qg = q.float().reshape(b, hk, g, dh)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k) * (1.0 / math.sqrt(dh))
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgc,bckd->bkgd", p, v) / l
    return out.reshape(b, h, dh).to(q.dtype)


def paged_chunk_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              q_pos: torch.Tensor, *,
                              window: int = 0) -> torch.Tensor:
    """Gather-then-attend chunked-prefill attention.

    q          (B, C, H, Dh)      the chunk's queries
    k/v_pages  (P, page, Hk, Dh)  shared page pool, the chunk's K/V written
    page_table (B, max_pages)     page ids per row, row-major in time
    q_pos      (B, C)             absolute query positions, -1 = padded
    -> (B, C, H, Dh) in q's dtype.

    Each row's whole table is gathered in position order (slot ``t`` holds
    position ``t``; page ids clamped to the pool) and attended by
    ``models.attention.chunk_attention``, the counterpart of the JAX
    package's chunked prefill: query ``i`` sees slots ``t <= q_pos[i]``, and
    a padded query the mean of V over the whole table.
    """
    b, _, _, dh = q.shape
    n_pool, page_size, hk, _ = k_pages.shape
    n_ctx = page_table.shape[1] * page_size
    pt = page_table.long().clamp(0, n_pool - 1)
    kg = k_pages[pt].reshape(b, n_ctx, hk, dh)
    vg = v_pages[pt].reshape(b, n_ctx, hk, dh)
    return chunk_attention(q, kg, vg, torch.arange(n_ctx, device=q.device),
                           q_pos, window=window)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """Whole-sequence GQA attention with a float32 softmax.

    q (B, Sq, H, Dh); k/v (B, Skv, Hk, Dh) -> (B, Sq, H, Dh) in q's dtype;
    with ``return_lse`` also each score row's log-sum-exp ``m + log(l)``
    (B, Hk, G, Sq) float32, as ``repro.models.attention._flash_impl``
    returns it (the training backward's residual).

    Computes what ``repro.kernels.flash_attention.flash_attention_pallas``
    and ``repro.models.attention.flash_attention`` compute with
    ``q_offset == 0``: query ``i`` sees key ``j`` when ``j <= i`` (causal)
    and ``j > i - window`` (window > 0), scores scaled by ``1/sqrt(Dh)``
    and masked with ``NEG_INF``, ``l`` floored at ``1e-30``.  The JAX
    function's ``q_chunk`` / ``kv_chunk`` / ``scheme`` only bound its
    memory, so this version is not chunked.  A masked score contributes
    exactly zero, so a row that sees no key is zeros (the JAX functions
    there return a padding-dependent mean of V; the serving path never
    asks, since every causal query sees itself).
    """
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.float().reshape(b, sq, hk, g, dh)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * (1.0 / math.sqrt(dh))
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgqc,bckd->bkgqd", p, v.float()) / l
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

    a, b (B, S, Dr); h0 (B, Dr) or None (zeros) -> every h_t (B, S, Dr)
    float32.

    Computes what ``repro.kernels.rglru_scan.rglru_scan_pallas`` and the
    associative scan ``repro.models.rglru.rglru_scan`` compute, as a plain
    loop over time in float32.  Each step is a multiply, rounded, and then
    an add, rounded: two operations, never one fused multiply-add, which is
    how the CUDA kernel rounds too, so the two agree bit for bit.
    """
    a, b = a.float(), b.float()
    bsz, s, dr = a.shape
    h = torch.zeros((bsz, dr), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty((bsz, s, dr), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = torch.mul(a[:, t], h)
        h = torch.add(h, b[:, t])
        out[:, t] = h
    return out
