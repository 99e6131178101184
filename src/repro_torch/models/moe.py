"""Mixture-of-experts FFN with capacity-based dispatch (counterpart of
``repro.models.moe``).

Every token picks its top-k experts from a float32 softmax router; each
expert accepts at most ``C = max(4, ceil(N·k/E · capacity_factor))`` token
slots of the N tokens of the call, numbered in token-major order over the
flattened ``(N·k)`` assignments, and the slots past ``C`` are dropped
(combine weight zero), GShard's rule.  Shapes are fixed throughout, so a
call costs the host no device-to-host transfer: an ``(E, C, D)`` dispatch
buffer filled by an accumulating ``index_put_``, one batched SwiGLU over
every expert (``torch.bmm``, as the JAX package's ``einsum``), and a
gather with a float32 weighted sum for the combine.  Every expert's
weights are read on every call whatever the routing, as in the JAX
design.

``moe_ffn`` is the four steps ``router_probs`` -> ``dispatch`` ->
``_expert_ffn`` -> ``combine``, which the card's measurement times one by
one.  ``expert_shard=(e_start, e_count)`` computes the partial output of
an expert slice (the JAX package's manual expert-parallel form; the
partial outputs of the slices sum to the whole); the ``constrain_*``
sharding hints of the JAX package have no counterpart on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig


def router_probs(x: torch.Tensor, w_router: torch.Tensor, moe: MoEConfig):
    """x (N, D) -> (topv (N, k) float32 combine weights, topi (N, k) int64
    expert ids, probs (N, E) float32).

    The logits are float32 from the activations whatever their dtype (the
    JAX package's ``preferred_element_type``).  The top k come from a
    stable descending sort: among equal probabilities the lower expert id
    comes first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises
    no order, and one swapped tie changes which later token a full expert
    drops)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = moe.experts_per_token
    topv, topi = vals[:, :k], ids[:, :k]
    if moe.normalize_router_weights:
        topv = topv / topv.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return topv, topi, probs


def expert_capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = math.ceil(n_tokens * moe.experts_per_token / moe.num_experts
                  * moe.capacity_factor)
    return max(4, c)


def _positions_in_expert(topi: torch.Tensor, num_experts: int):
    """(flat expert ids (N·k,), slot of each assignment within its expert
    (N·k,)): a running count over the assignments in token-major order."""
    flat_e = topi.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(
        num_experts, device=topi.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1                     # (N·k, E)
    return flat_e, pos.gather(1, flat_e[:, None])[:, 0]


def dispatch(x: torch.Tensor, topi: torch.Tensor, moe: MoEConfig,
             expert_shard: Optional[tuple] = None):
    """Place each kept (token, choice) pair in its expert's buffer.

    Returns (buf (E_local, C, D) in x's dtype, keep (N·k,) bool, local
    expert ids and slots (N·k,) for the combine).  A dropped pair is sent
    to slot ``C - 1`` with a zero contribution, which leaves that slot's
    value unchanged."""
    n, d = x.shape
    k = moe.experts_per_token
    cap = expert_capacity(n, moe)
    flat_e, pos_in_e = _positions_in_expert(topi, moe.num_experts)
    keep = pos_in_e < cap
    if expert_shard is None:
        e_start, e_count = 0, moe.num_experts
    else:
        e_start, e_count = expert_shard
        keep = keep & (flat_e >= e_start) & (flat_e < e_start + e_count)
    local_e = (flat_e - e_start).clamp(0, e_count - 1)
    slot = torch.where(keep, pos_in_e, cap - 1)
    x_rep = x[:, None].expand(n, k, d).reshape(n * k, d)
    contrib = torch.where(keep[:, None], x_rep, 0).to(x.dtype)
    buf = torch.zeros((e_count, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((local_e, slot), contrib, accumulate=True)
    return buf, keep, local_e, slot


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """buf (E, C, D) through each expert's SwiGLU -> (E, C, D)."""
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, wd)


def combine(out_buf: torch.Tensor, topv: torch.Tensor, keep: torch.Tensor,
            local_e: torch.Tensor, slot: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's kept expert outputs, weighted in float32 and summed:
    (N, D) in ``dtype``."""
    n, k = topv.shape
    gathered = out_buf[local_e, slot].float()                 # (N·k, D)
    weights = torch.where(keep, topv.reshape(-1), 0.0)
    out = (gathered * weights[:, None]).reshape(n, k, -1).sum(dim=1)
    return out.to(dtype)


def moe_ffn(x: torch.Tensor, w: dict, moe: MoEConfig, *,
            expert_shard: Optional[tuple] = None,
            token_chunk: int = 0) -> torch.Tensor:
    """The MoE FFN over tokens x (N, D); w holds ``"router"`` (D, E)
    float32 and ``"wg"``, ``"wu"`` (E, D, d_expert), ``"wd"`` (E, d_expert,
    D).  With ``expert_shard`` the weights hold only that slice's experts
    and the result is its partial output.  ``token_chunk`` > 0 runs the
    tokens in chunks of that size when it divides N, each chunk with its
    own capacity, as the JAX package's scan does."""
    n, d = x.shape
    if token_chunk and n > token_chunk and n % token_chunk == 0:
        return torch.cat([moe_ffn(xc, w, moe, expert_shard=expert_shard)
                          for xc in x.split(token_chunk)])
    topv, topi, _ = router_probs(x, w["router"], moe)
    buf, keep, local_e, slot = dispatch(x, topi, moe, expert_shard)
    out_buf = _expert_ffn(buf, w["wg"], w["wu"], w["wd"])
    return combine(out_buf, topv, keep, local_e, slot, x.dtype)


def moe_load_balance_loss(probs: torch.Tensor, topi: torch.Tensor,
                          moe: MoEConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: E · sum_e f_e · P_e."""
    e = torch.arange(moe.num_experts, device=topi.device)
    route_frac = (topi[..., None] == e).float().mean(dim=(0, 1))
    prob_frac = probs.mean(dim=0)
    return moe.num_experts * (route_frac * prob_frac).sum()
