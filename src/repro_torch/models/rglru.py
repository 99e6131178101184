"""Griffin / RecurrentGemma recurrent block: causal conv + RG-LRU + gating
(counterpart of ``repro.models.rglru``).

The RG-LRU recurrence is linear in its hidden state,

    h_t = a_t * h_{t-1} + b_t,
    a_t = exp(-c * softplus(L) * sigmoid(r_t)),
    b_t = sqrt(1 - a_t^2) * (i_t * x_t),

so a prefill runs it as one scan over time (``kernels.ops.rglru_scan``: the
Hopper kernel on the card, its plain loop on the CPU; the JAX package uses
an associative scan here, so the two round differently within float32) and
decode as one elementwise step.  Dtypes follow the JAX package: the
projections in the compute dtype, then gates, conv accumulation and the
state in float32, and the output cast back before ``wo``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

RGLRU_C = 8.0      # the paper's fixed decay sharpness constant


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` everywhere, as ``jax.nn.softplus`` computes it
    (``torch.nn.functional.softplus`` returns ``x`` itself above 20)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def rglru_gates(x: torch.Tensor, w: dict, num_heads: int):
    """(a, b) coefficients of the recurrence.

    x (B, S, Dr) post-conv activations -> a, b (B, S, Dr) float32."""
    bsz, s, dr = x.shape
    xh = x.reshape(bsz, s, num_heads, dr // num_heads)
    # block-diagonal gate projections (per head)
    r = torch.einsum("bshd,hde->bshe", xh, w["gate_a_w"]).reshape(bsz, s, dr)
    i = torch.einsum("bshd,hde->bshe", xh, w["gate_x_w"]).reshape(bsz, s, dr)
    r = torch.sigmoid(r.float() + w["gate_a_b"].float())
    i = torch.sigmoid(i.float() + w["gate_x_b"].float())
    log_a = -RGLRU_C * softplus(w["lam"].float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1: 1 - exp(2 log a)
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = mult * (i * x.float())
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every h_t (B, S, Dr) float32 of the recurrence from ``h0``."""
    return kops.rglru_scan(a.float().contiguous(), b.float().contiguous(),
                           None if h0 is None else h0.float().contiguous())


def rglru_step(a: torch.Tensor, b: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """One decode step: (B, Dr) each."""
    return a * h + b


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None):
    """Depthwise causal temporal conv.

    x (B, S, Dr); w (cw, Dr); state (B, cw-1, Dr) trailing inputs of the
    previous segment.  ``valid`` (B, S) marks real tokens of a right-padded
    segment: the carried state is then the window ending at each row's last
    *valid* input (a row with none keeps the previous state).  Returns
    (y in x's dtype, new_state)."""
    cw = w.shape[0]
    bsz, s, dr = x.shape
    if state is None:
        state = torch.zeros((bsz, cw - 1, dr), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+cw-1, Dr)
    y = torch.zeros((bsz, s, dr), dtype=torch.float32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + s].float() * w[cw - 1 - i].float()
    y = y + b.float()
    if cw == 1:
        new_state = xp[:, :0]
    elif valid is None:
        new_state = xp[:, -(cw - 1):]
    else:
        # xp index of token j is j + cw - 1; the gather stays on the device
        last = valid.sum(dim=1) - 1                                # (B,)
        idx = last[:, None] + 1 + torch.arange(cw - 1, device=x.device)
        new_state = xp.gather(1, idx[..., None].expand(-1, -1, dr))
    return y.to(x.dtype), new_state


def rglru_block(x: torch.Tensor, w: dict, num_heads: int, *, mode: str,
                state: Optional[dict],
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The Griffin recurrent mixer (everything between the residual adds).

    x (B, S, D) normalised input; state {"h": (B, Dr) float32, "conv":
    (B, cw-1, Dr)} or None.  ``valid`` (B, S) marks the real tokens of a
    right-padded prefill: pad steps become identities (a = 1, b = 0) and
    the carried state is that of each row's last valid step.  Returns
    (y (B, S, D) in x's dtype, the new state or None); the caller decides
    where the new state goes."""
    gate = F.gelu((x @ w["wg"]).float(), approximate="tanh")
    main = x @ w["wx"]                                         # (B, S, Dr)
    conv_state = state["conv"] if state is not None else None
    main, new_conv = causal_conv1d(main, w["conv_w"], w["conv_b"], conv_state,
                                   valid=valid)
    a, b = rglru_gates(main, w, num_heads)
    if valid is not None and mode != "decode":
        a = torch.where(valid[..., None], a, 1.0)
        b = torch.where(valid[..., None], b, 0.0)
    if mode == "decode":
        h = rglru_step(a[:, 0], b[:, 0], state["h"])           # (B, Dr)
        hs = h[:, None]
    else:
        h0 = state["h"] if state is not None else None
        hs = rglru_scan(a, b, h0)                              # (B, S, Dr)
        if valid is None:
            h = hs[:, -1]
        else:
            last = valid.sum(dim=1) - 1                        # (B,)
            idx = last.clamp(min=0)[:, None, None].expand(-1, 1, hs.shape[-1])
            h = hs.gather(1, idx)[:, 0]
            if h0 is not None:
                h = torch.where((last >= 0)[:, None], h, h0.float())
    y = (hs * gate).to(x.dtype) @ w["wo"]
    new_state = None if state is None else {"h": h, "conv": new_conv}
    return y, new_state
