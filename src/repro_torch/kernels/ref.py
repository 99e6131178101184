"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.  The router (``kernels.ops``)
never takes them for a CUDA tensor.
"""

from __future__ import annotations

import math

import torch

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
