"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517] (counterpart of ``repro.models.xlstm``).

mLSTM's gates depend only on the input, so its ``(C, n)`` recurrence is
linear time-varying and has a chunkwise-parallel form: quadratic inside a
chunk of ``L`` tokens, recurrent across chunks.  ``mlstm_sequential`` is
the exact step-by-step oracle, ``mlstm_chunkwise`` the prefill path and
``mlstm_step`` the decode step.  sLSTM's gates read the previous hidden
state, so it runs step by step, with block-diagonal (per-head) recurrent
weights.  Dtypes follow the JAX package: the projections in the compute
dtype, the gates, the recurrences and the states in float32.

States (one row a sequence):
  mLSTM: {"c": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)} float32,
         with dh = d_rnn / H (640 for xlstm-1.3b, not ``cfg.head_dim``)
  sLSTM: {"c", "n", "h", "m": (B, Dr)} float32 (``n`` starts at 1e-6)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.rglru import softplus

# a right-padded step of a prefill: forget gate 1 (log sigmoid(40) rounds
# to 0 in float32), input gate 0, so the carried state ignores it
PAD_F = 40.0
PAD_I = -1e30


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_qkv_gates(xm: torch.Tensor, w: dict, num_heads: int):
    """The main branch xm (B, S, Dr) -> per-head q, k, v (B, S, H, dh) in
    xm's dtype and the raw gates i, f (B, S, H) float32.  k is divided by
    sqrt(dh) rounded to xm's dtype, as the JAX package divides it."""
    b, s, dr = xm.shape
    dh = dr // num_heads
    xh = xm.reshape(b, s, num_heads, dh)
    q = torch.einsum("bshd,hde->bshe", xh, w["wq"])
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(xm.dtype)
    k = torch.einsum("bshd,hde->bshe", xh, w["wk"]) / scale
    v = torch.einsum("bshd,hde->bshe", xh, w["wv"])
    xf = xh.float()
    i_raw = torch.einsum("bshd,hd->bsh", xf, w["w_i"].float()) + \
        w["b_i"].float()
    f_raw = torch.einsum("bshd,hd->bsh", xf, w["w_f"].float()) + \
        w["b_f"].float()
    return q, k, v, i_raw, f_raw


def mlstm_zero_state(batch: int, num_heads: int, head_dim: int,
                     device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, num_heads, head_dim, head_dim), **f32),
            "n": torch.zeros((batch, num_heads, head_dim), **f32),
            # m = 0 <=> no history yet (the sequential init)
            "m": torch.zeros((batch, num_heads), **f32)}


def mlstm_step(q, k, v, i_raw, f_raw, state: dict):
    """One exact step: q, k, v (B, H, dh); i_raw, f_raw (B, H) float32.
    Returns (h (B, H, dh) float32, the new state)."""
    c, n, m = state["c"], state["n"], state["m"]
    log_f = _log_sigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    c_new = f_g[..., None, None] * c + i_g[..., None, None] * (
        vf[..., :, None] * kf[..., None, :])            # (B, H, dh_v, dh_k)
    n_new = f_g[..., None] * n + i_g[..., None] * kf
    num = torch.einsum("bhvk,bhk->bhv", c_new, qf)
    den = torch.einsum("bhk,bhk->bh", n_new, qf).abs()
    den = torch.maximum(den, torch.exp(-m_new))
    return num / den[..., None], {"c": c_new, "n": n_new, "m": m_new}


def mlstm_sequential(q, k, v, i_raw, f_raw, state: Optional[dict] = None):
    """The exact O(S) recurrence over (B, S, H, dh) inputs, step by step:
    the oracle of ``mlstm_chunkwise``.  Returns (h (B, S, H, dh) float32,
    the final state)."""
    b, s, hn, dh = q.shape
    if state is None:
        state = mlstm_zero_state(b, hn, dh, q.device)
    hs = []
    for t in range(s):
        h, state = mlstm_step(q[:, t], k[:, t], v[:, t], i_raw[:, t],
                              f_raw[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state: Optional[dict] = None, *,
                    chunk: int = 64):
    """The chunkwise-parallel mLSTM: an attention-like term inside each
    chunk plus the state carried across chunks, stabilised by a running
    maximum ``m``.  q, k, v (B, S, H, dh); i_raw, f_raw (B, S, H) float32.
    A ragged tail is padded with identity steps (f = 40, i = -1e30).
    Returns (h (B, S, H, dh) float32, the final state)."""
    b, s, hn, dh = q.shape
    if state is None:
        state = mlstm_zero_state(b, hn, dh, q.device)
    chunk = max(1, min(chunk, s))
    pad = (-s) % chunk
    if pad:
        def zpad(x):
            return torch.cat([x, x.new_zeros((b, pad) + x.shape[2:])], 1)
        q, k, v = zpad(q), zpad(k), zpad(v)
        f_raw = torch.cat([f_raw, f_raw.new_full((b, pad, hn), PAD_F)], 1)
        i_raw = torch.cat([i_raw, i_raw.new_full((b, pad, hn), PAD_I)], 1)
    nc = (s + pad) // chunk
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    c0, n0, m0 = state["c"], state["n"], state["m"]
    hs = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ic = i_raw[:, sl]
        csum = torch.cumsum(_log_sigmoid(f_raw[:, sl]), dim=1)   # F_t
        g = ic - csum                                            # i_s - F_s
        g_run = torch.cummax(g, dim=1).values                    # max_{s<=t}
        m_t = torch.maximum(m0[:, None] + csum, csum + g_run)    # (B, L, H)
        scores = torch.einsum("blhd,buhd->bhlu", qf, kf)         # (B, H, t, s)
        # logD[t, s] = F_t - F_s + i_s - m_t for s <= t; -inf above the
        # diagonal, so exp gives 0 there (never NaN: every term is finite)
        logD = (csum[:, :, None, :] - csum[:, None, :, :]
                + ic[:, None, :, :] - m_t[:, :, None, :])        # (B, t, s, H)
        logD = torch.where(tri[None, :, :, None], logD, float("-inf"))
        ds = torch.exp(logD).permute(0, 3, 1, 2) * scores        # (B, H, t, s)
        intra_num = torch.einsum("bhts,bshd->bthd", ds, vf)
        intra_den = ds.sum(dim=-1).permute(0, 2, 1)              # (B, t, H)
        inter_w = torch.exp(m0[:, None] + csum - m_t)            # (B, L, H)
        inter_num = torch.einsum("bhvk,blhk->blhv", c0, qf) * \
            inter_w[..., None]
        inter_den = torch.einsum("bhk,blhk->blh", n0, qf) * inter_w
        den = (intra_den + inter_den).abs()
        den = torch.maximum(den, torch.exp(-m_t))
        hs.append((intra_num + inter_num) / den[..., None])      # (B, L, H, dh)
        # the state at the chunk's end
        f_l = csum[:, -1]                                        # (B, H)
        m_next = torch.maximum(m0 + f_l, f_l + g_run[:, -1])
        w_src = torch.exp(f_l[:, None] + g - m_next[:, None])    # (B, L, H)
        decay = torch.exp(m0 + f_l - m_next)
        c0 = decay[..., None, None] * c0 + torch.einsum(
            "blhv,blhk->bhvk", w_src[..., None] * vf, kf)
        n0 = decay[..., None] * n0 + torch.einsum("blh,blhk->bhk", w_src, kf)
        m0 = m_next
    h = torch.cat(hs, dim=1)[:, :s]
    return h, {"c": c0, "n": n0, "m": m0}


def mlstm_block(x: torch.Tensor, w: dict, num_heads: int, *, mode: str,
                state: Optional[dict], chunk: int = 64,
                use_sequential: bool = False,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """The mLSTM mixer: up-projections, the per-head matrix-memory
    recurrence, the gated output and the down-projection.  x (B, S, D)
    normalised input.  ``valid`` (B, S) marks the real tokens of a
    right-padded prefill: pad steps force f = 40, i = -1e30 (identity
    steps).  Returns (y (B, S, D) in x's dtype, the new state)."""
    xm = x @ w["wm"]                                   # main branch (B, S, Dr)
    xz = x @ w["wz"]                                   # gate branch
    q, k, v, i_raw, f_raw = mlstm_qkv_gates(xm, w, num_heads)
    if valid is not None and mode != "decode":
        i_raw = torch.where(valid[..., None], i_raw, PAD_I)
        f_raw = torch.where(valid[..., None], f_raw, PAD_F)
    if mode == "decode":
        h, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                                  f_raw[:, 0], state)
        hs = h[:, None]
    elif use_sequential:
        hs, new_state = mlstm_sequential(q, k, v, i_raw, f_raw, state)
    else:
        hs, new_state = mlstm_chunkwise(q, k, v, i_raw, f_raw, state,
                                        chunk=chunk)
    b, s = x.shape[:2]
    y = hs.reshape(b, s, -1).to(x.dtype) * F.silu(xz.float()).to(x.dtype)
    return y @ w["wo"], new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_zero_state(batch: int, d_rnn: int, device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d_rnn), **f32),
            "n": torch.full((batch, d_rnn), 1e-6, **f32),
            "h": torch.zeros((batch, d_rnn), **f32),
            "m": torch.zeros((batch, d_rnn), **f32)}


def _slstm_cell(zx: torch.Tensor, st: dict, r_w: torch.Tensor,
                num_heads: int) -> dict:
    """One sLSTM step.  zx (B, 4, Dr) float32 input projections (i, f, z,
    o); r_w (4, H, dh, dh) float32 recurrent weights."""
    c, n, h, m = st["c"], st["n"], st["h"], st["m"]
    b, dr = h.shape
    hh = h.reshape(b, num_heads, dr // num_heads)
    rec = torch.einsum("bhd,ghde->gbhe", hh, r_w).reshape(4, b, dr)
    i_raw = zx[:, 0] + rec[0]
    f_raw = zx[:, 1] + rec[1]
    z_raw = zx[:, 2] + rec[2]
    o_raw = zx[:, 3] + rec[3]
    log_f = _log_sigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_raw)
    n_new = (f_g * n + i_g).clamp(min=1e-6)
    h_new = torch.sigmoid(o_raw) * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_block(x: torch.Tensor, w: dict, num_heads: int, *, mode: str,
                state: Optional[dict],
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """The sLSTM mixer: input projections, the step-by-step recurrence and
    the down-projection.  x (B, S, D); w {"w_in": (4, D, Dr), "b_in": (4,
    Dr) float32, "r": (4, H, dh, dh), "wo": (Dr, D)}.  ``valid`` (B, S)
    marks the real tokens of a right-padded prefill: a pad step carries
    the state through unchanged.  Returns (y (B, S, D), the new state)."""
    b, s, _ = x.shape
    zx = torch.einsum("bsd,gde->bsge", x, w["w_in"]).float() + \
        w["b_in"].float()                                        # (B, S, 4, Dr)
    st = state if state is not None else slstm_zero_state(
        b, w["wo"].shape[0], x.device)
    r_w = w["r"].float()
    if mode == "decode":
        st = _slstm_cell(zx[:, 0], st, r_w, num_heads)
        hs = st["h"][:, None]
    else:
        out = []
        for t in range(s):
            new = _slstm_cell(zx[:, t], st, r_w, num_heads)
            if valid is not None:
                vt = valid[:, t, None]
                new = {name: torch.where(vt, a, st[name])
                       for name, a in new.items()}
            st = new
            out.append(st["h"])
        hs = torch.stack(out, dim=1)                             # (B, S, Dr)
    return hs.to(x.dtype) @ w["wo"], st
