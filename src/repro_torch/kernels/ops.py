"""Dispatch between the hand-written kernels and their plain versions.

The route is decided by where the tensors lie, and nothing else
(``route``): a CPU tensor goes to the plain PyTorch version in
``kernels.ref``; a CUDA tensor goes to the Hopper kernel, which raises on a
shape or dtype it does not take; a meta tensor (the dry run's allocation-
free trace, ``launch.dryrun``) gets empty outputs of the kernel's shapes
and dtypes.  No shape ever sends a CUDA tensor to the plain version or the
meta route, and no failure falls through to either.  The meta and CUDA
routes book the kernel's flops and bytes (``kernels.cost``) with the dry
run's counter when one is open; with none open that is one list test.
The paged kernels have no meta route: the dry run decodes and prefills
over dense caches, as the JAX dry run does, and a meta pool raises in the
wrapper.

When a training step asks for gradients (grad mode on and an input that
requires grad), the flash and scan calls go through the
``torch.autograd.Function``s below, whose forwards take the same routes;
otherwise they launch exactly as the serving path always has.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost, ref
from repro_torch.kernels.chunk_attention import \
    paged_chunk_attention as _chunk_cuda
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_cuda
from repro_torch.kernels.paged_attention import \
    paged_decode_attention as _paged_cuda
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru_cuda


def route(device: torch.device) -> str:
    """``"plain"`` for the CPU, ``"meta"`` for the meta device, else
    ``"kernel"``: a CUDA tensor always goes to the hand-written kernel."""
    if device.type == "cpu":
        return "plain"
    return "meta" if device.type == "meta" else "kernel"


def _meta_only(name: str, *tensors) -> None:
    """The meta route takes meta tensors only: a mix of devices raises,
    as the kernel's own check would."""
    for t in tensors:
        if t is not None and t.device.type != "meta":
            raise ValueError(f"{name}: the meta route got a tensor on "
                             f"{t.device}; every input must be on meta")


def _flash_meta(q, k, v, causal: bool, window: int, return_lse: bool):
    """The kernel's outputs, empty, on meta: (B, Sq, H, Dh) in q's dtype
    and with ``return_lse`` the (B, Hk, G, Sq) float32 log-sum-exp.  A
    group size the kernel is not built for pads on the card
    (``kernels.groups``); those copies are not traced."""
    _meta_only("flash_attention", q, k, v)
    cost.record_flash(q, k, causal, window, return_lse)
    out = torch.empty_like(q)
    if not return_lse:
        return out
    b, sq, h, _ = q.shape
    hk = k.shape[2]
    return out, torch.empty((b, hk, h // hk, sq), dtype=torch.float32,
                            device=q.device)


def _flash_kernel(q, k, v, causal: bool, window: int, return_lse: bool):
    """The CUDA route: book the call, launch the kernel."""
    cost.record_flash(q, k, causal, window, return_lse)
    return _flash_cuda(q, k, v, causal=causal, window=window,
                       return_lse=return_lse)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          q_pos: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """A prefill chunk's attention over the paged pool (chunked prefill);
    shapes as in ``kernels.ref``.  The CUDA kernel takes int32 tables and
    positions and ``window == 0`` only, and raises otherwise."""
    if q.device.type == "cpu":
        return ref.paged_chunk_attention_ref(q, k_pages, v_pages, page_table,
                                             q_pos, window=window)
    return _chunk_cuda(q, k_pages, v_pages, page_table, q_pos,
                       window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Whole-sequence attention forward (exact-length prefill, training);
    shapes as in ``kernels.ref``.  The JAX router also asks for ``q_offset
    == 0`` and ``Sq, Skv >= 8``: the exact path always meets both (prompts
    are bucketed to at least 8 tokens), and the kernel raises otherwise.
    With gradients wanted, ``FlashAttention``."""
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    r = route(q.device)
    if r == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if r == "meta":
        return _flash_meta(q, k, v, causal, window, False)
    return _flash_kernel(q, k, v, causal, window, False)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` (prefill and
    training forward of the recurrent layers); shapes as in
    ``kernels.ref``.  The JAX router sends only ``Dr % 128 == 0, S >= 8``
    to its kernel; the CUDA kernel takes every S and every Dr that is a
    multiple of 4 (its TMA loads need 16-byte rows), and raises on any
    other Dr: no shape is routed elsewhere.  recurrentgemma-9b serves at
    Dr = 4096.  With gradients wanted, ``RGLRUScan``."""
    if _wants_grad(a, b, h0):
        return RGLRUScan.apply(a, b, h0)
    return _scan(a, b, h0)


def _scan(a, b, h0=None):
    r = route(a.device)
    if r == "plain":
        return ref.rglru_scan_ref(a, b, h0)
    if r == "meta":
        # the kernel's output, empty: every h_t (B, S, Dr) float32
        _meta_only("rglru_scan", a, b, h0)
        cost.record_scan(a, h0)
        return torch.empty(a.shape, dtype=torch.float32, device=a.device)
    cost.record_scan(a, h0)
    return _rglru_cuda(a, b, h0)


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient, as ``jax.custom_vjp`` wraps the
    JAX package's (``repro.models.attention._flash_vjp``).

    The forward is the kernel with its log-sum-exp output on a CUDA
    tensor, ``ref.flash_attention_ref(return_lse=True)`` on the CPU, or
    the meta route's empty outputs on meta; it saves ``(q, k, v, out,
    lse)``.  The backward is ``models.attention.flash_attention_bwd`` on
    every device (the JAX
    backward is jnp, not Pallas), so the CPU tests hold the very code the
    card runs against ``jax.grad``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        r = route(q.device)
        if r == "plain":
            out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window, return_lse=True)
        elif r == "meta":
            out, lse = _flash_meta(q, k, v, causal, window, True)
        else:
            out, lse = _flash_kernel(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.models.attention import flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with a gradient.

    The forward is the scan (kernel or plain loop, by device) and saves
    ``a``, every ``h_t`` and ``h0``.  The backward is the same recurrence
    run backwards in time, ``g_t = dh_t + a_{t+1} g_{t+1}`` with ``g_S =
    dh_S``: one more scan, of ``flip(dh)`` with coefficients ``flip`` of
    ``a`` shifted left by one step (zero at the end), from a zero state,
    so on the card it is one more launch of the same kernel.  Then ``db =
    g``, ``da_t = g_t h_{t-1}`` (``h_0`` the initial state) and ``dh0 =
    a_1 g_1``."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs = _scan(a, b, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.b_dtype = b.dtype
        return hs

    @staticmethod
    def backward(ctx, dhs):
        a, hs, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = _scan(a_next.flip(1), dhs.float().flip(1).contiguous()).flip(1)
        h_prev = torch.cat([torch.zeros_like(hs[:, :1]) if h0 is None
                            else h0[:, None].float(), hs[:, :-1]], dim=1)
        da = g * h_prev
        dh0 = None if h0 is None else (a[:, 0] * g[:, 0]).to(h0.dtype)
        return da.to(a.dtype), g.to(ctx.b_dtype), dh0
