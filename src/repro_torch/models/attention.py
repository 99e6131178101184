"""Plain PyTorch attention for the serving path (counterpart of
``repro.models.attention``): chunk-continuation attention for chunked
prefill, and decode attention against a dense cache.

Both follow the JAX functions' arithmetic: scores in float32 scaled by
``1/sqrt(Dh)``, a finite ``NEG_INF`` mask, ``m`` floored at ``NEG_INF``
and ``l`` at ``1e-30``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def chunk_attention(q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                    kv_pos: torch.Tensor, q_pos: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Attention of a prefill chunk against gathered cache context.

    q      (B, C, H, Dh)  — the chunk's queries
    k/v    (B, T, Hk, Dh) — context gathered in position order; the chunk's
                            own keys are already written into it
    kv_pos (T,) or (B, T) — absolute position held by each context slot
    q_pos  (B, C)         — absolute query positions, -1 = padded query

    The mask is ``kv_pos <= q_pos`` (and the sliding window when given).
    Padded queries give finite values, never NaN.
    """
    b, c, h, dh = q.shape
    hk = k_ctx.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, c, hk, g, dh).permute(0, 2, 3, 1, 4)  # B,Hk,G,C,D
    s = torch.einsum("bkgqd,btkd->bkgqt", qg, k_ctx.float()) * scale
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None]
    kp = kv_pos[:, None, :]
    qp = q_pos[:, :, None]
    mask = (kp <= qp) & (kp >= 0)
    if window > 0:
        mask &= kp > (qp - window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1).clamp(min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp(min=1e-30)
    pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(v_ctx.dtype).float(),
                      v_ctx.float())
    out = (pv / l[..., None]).to(q.dtype)                   # B,Hk,G,C,D
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     cur_pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Single-token attention against a dense KV cache.

    q         (B, H, Dh)
    k/v cache (B, C, Hk, Dh)
    slot_pos  (B, C) absolute position stored in each slot (-1 empty)
    cur_pos   (B,)  position of the query token
    """
    b, h, dh = q.shape
    hk = k_cache.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, hk, g, dh)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * scale
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window > 0:
        valid &= slot_pos > (cur_pos[:, None] - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgc,bckd->bkgd", (p / l).to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)
