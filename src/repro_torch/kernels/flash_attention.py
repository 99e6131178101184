"""Hopper flash-attention forward kernel: the Python wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas`` (wrapper at
``src/repro/kernels/flash_attention.py:107``, ``pl.pallas_call`` at
``:136``, kernel body ``_flash_kernel``).  It is CUDA C++ for ``sm_90a``,
built by ``kernels.build`` and bound with ``ctypes``.  Its plain version is
``kernels.ref.flash_attention_ref``.

Design: bf16 runs one warp-specialised kernel per (Dh, G): a block owns
128 score rows (128 / G query positions x the G heads of one kv head); one
producer warp loads the Q tile and a ring of 64-key K/V tiles through TMA
(rank-4 tensor maps over ``(Dh, heads, S, B)``, built per launch, that fill
zeros past ``Sq`` / ``Skv``); two consumer warpgroups run both products on
``wgmma`` (P entering P.V as hi + lo bf16 terms) with an online softmax,
masking only the tiles that cross the diagonal, a window edge or ``Skv``.
float32 runs scalar FMAs (64 score rows x 32-key tiles).

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches on the current stream and counts the launch.  The kernel is
instantiated for G in ``GROUP_SIZES``; any other G goes through
``kernels.groups`` (zero query rows pad each group to a size the kernel
takes, G above 16 is cut into launches of 16, and the pad rows are
dropped), one counted launch each.  Anything the kernel
does not take raises — there is no fallback to the plain version.  The TPU
kernel's ``_TUNED_BLOCKS`` / ``tuned_flash_blocks`` / ``vmem_bytes`` size
its blocks to TPU VMEM and have no counterpart here: the CUDA kernel's
tiles are fixed by Hopper's shared memory and registers.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, groups

HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8, 16)
MIN_SEQ = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(q, k, v, window: int) -> None:
    """Raise ``ValueError`` for anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, the "
                             "kernel needs every input on the same CUDA "
                             f"device as q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(bfloat16 or float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: want q (B,Sq,H,Dh) and k/v "
                         "(B,Skv,Hk,Dh) of one shape")
    b, sq, h, dh = q.shape
    bk, skv, hk, dh_k = k.shape
    if bk != b or b < 1:
        raise ValueError(f"flash_attention: batch {b} (q) vs {bk} (k/v)")
    if dh_k != dh or dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} (k/v {dh_k}) not "
                         f"in {HEAD_DIMS}")
    if hk < 1 or h % hk:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"Hk={hk}")
    if sq < MIN_SEQ or skv < MIN_SEQ:
        raise ValueError(f"flash_attention: Sq={sq}, Skv={skv}; the kernel "
                         f"takes sequences of at least {MIN_SEQ}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA attention forward, on the card.

    q (B, Sq, H, Dh); k/v (B, Skv, Hk, Dh) -> (B, Sq, H, Dh) in q's dtype.
    ``flash_attention.launches`` counts launches.
    """
    check_inputs(q, k, v, window)
    hk = k.shape[2]
    plan = groups.group_plan(q.shape[2] // hk, GROUP_SIZES)
    if len(plan) == 1 and plan[0][1] == plan[0][2]:
        return _launch(q, k, v, causal, window)
    outs = [_launch(qi, k, v, causal, window)
            for qi in groups.split_groups(q, hk, plan, 2)]
    return groups.merge_groups(outs, hk, plan, 2)


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """One kernel launch, at a group size in ``GROUP_SIZES``."""
    lib = _library()
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, h, hk, dh, int(bool(causal)), window,
            1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed (code {rc}) for "
                           f"q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
