"""Plain PyTorch attention (counterpart of ``repro.models.attention``):
chunk-continuation attention for chunked prefill, decode attention
against a dense cache, and the flash-attention backward of a training
step.

They follow the JAX functions' arithmetic: scores in float32 scaled by
``1/sqrt(Dh)``, a finite ``NEG_INF`` mask, ``m`` floored at ``NEG_INF``
and ``l`` at ``1e-30``.  The forward of whole-sequence attention is the
flash kernel (``kernels.ops.flash_attention``).
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """(dq, dk, dv) of whole-sequence GQA attention, in q's / k's / v's
    dtypes: the port of ``repro.models.attention._flash_vjp_bwd``.

    q, out, dout (B, Sq, H, Dh); k, v (B, Skv, Hk, Dh); lse (B, Hk, G, Sq)
    float32, the forward's log-sum-exp.  The block scores are recomputed
    from (q, k, lse), one (q chunk, kv chunk) pair at a time and only for
    the pairs the causal / window mask leaves a live score in, so memory
    stays O(chunk^2) a head, never O(S^2).  Arithmetic in float32:
    ``p = exp(s - lse)``, ``dv += p^T dout``, ``ds = p * (dout v^T -
    rowsum(dout * out)) / sqrt(Dh)``, ``dq += ds k``, ``dk += ds^T q``.
    The JAX backward is plain jnp, not a Pallas kernel, and so is this."""
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(dh)

    def heads(x):                                   # -> (B, Hk, G, Sq, D)
        return x.float().reshape(b, sq, hk, g, dh).permute(0, 2, 3, 1, 4)

    qg, og, dg = heads(q), heads(out), heads(dout)
    kf, vf = k.float(), v.float()
    dvec = (dg * og).sum(dim=-1)                    # (B, Hk, G, Sq)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for qs in range(0, sq, q_chunk):
        qe = min(qs + q_chunk, sq)
        q_pos = torch.arange(qs, qe, device=q.device)[:, None]
        for ks in range(0, skv, kv_chunk):
            ke = min(ks + kv_chunk, skv)
            if causal and ks > qe - 1:
                continue                            # wholly above the diagonal
            if window > 0 and ke - 1 <= qs - window:
                continue                            # wholly outside the window
            kv_pos = torch.arange(ks, ke, device=q.device)[None]
            mask = torch.ones((qe - qs, ke - ks), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kv_pos <= q_pos
            if window > 0:
                mask &= kv_pos > q_pos - window
            q_c, do_c = qg[:, :, :, qs:qe], dg[:, :, :, qs:qe]
            k_c, v_c = kf[:, ks:ke], vf[:, ks:ke]
            s = torch.einsum("bkgqd,bckd->bkgqc", q_c, k_c) * scale
            p = torch.where(mask, torch.exp(s - lse[..., qs:qe, None]), 0.0)
            dv[:, ks:ke] += torch.einsum("bkgqc,bkgqd->bckd", p, do_c)
            dp = torch.einsum("bkgqd,bckd->bkgqc", do_c, v_c)
            ds = p * (dp - dvec[..., qs:qe, None]) * scale
            dq[:, :, :, qs:qe] += torch.einsum("bkgqc,bckd->bkgqd", ds, k_c)
            dk[:, ks:ke] += torch.einsum("bkgqc,bkgqd->bckd", ds, q_c)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
