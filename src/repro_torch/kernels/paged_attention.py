"""Hopper paged decode-attention kernel: the Python wrapper.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro.kernels.paged_attention.paged_decode_attention`` (``_paged_kernel``,
``pl.pallas_call`` at ``src/repro/kernels/paged_attention.py:206``).  It is
CUDA C++ for ``sm_90a``, built by ``kernels.build`` and bound with
``ctypes``.  Its plain version is ``kernels.ref.paged_decode_attention_ref``.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches on the current stream and counts the launch.  Anything the kernel
does not take raises — there is no fallback to the plain version.
``_TUNED_PPB`` / ``tuned_pages_per_block`` of the TPU kernel are keyed to
TPU VMEM and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)
PAGE_SIZES = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        fn = lib.paged_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(q, k_pages, v_pages, page_table, seq_lens, window: int):
    """Raise ``ValueError`` for anything the kernel does not take."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "seq_lens": seq_lens}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is on "
                             f"{t.device}, the kernel needs every input on "
                             f"the same CUDA device as q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_decode_attention: dtype {q.dtype} not "
                         "supported (bfloat16 or float32)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q, k_pages and v_pages "
                         "must share one dtype")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_decode_attention: page_table and seq_lens "
                         "must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_decode_attention: want q (B,H,Dh) and "
                         "k/v_pages (P,page,Hk,Dh) of one shape")
    b, h, dh = q.shape
    n_pool, page_size, hk, dh_k = k_pages.shape
    if dh_k != dh or dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {dh} (pool "
                         f"{dh_k}) not in {HEAD_DIMS}")
    if hk < 1 or h % hk or h // hk not in GROUP_SIZES:
        raise ValueError(f"paged_decode_attention: H={h} over Hk={hk} is not "
                         f"a group size in {GROUP_SIZES}")
    if page_size not in PAGE_SIZES:
        raise ValueError(f"paged_decode_attention: page size {page_size} "
                         f"not in {PAGE_SIZES}")
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            seq_lens.shape != (b,):
        raise ValueError("paged_decode_attention: want page_table (B, "
                         "max_pages) and seq_lens (B,)")
    if b < 1 or n_pool < 1 or page_table.shape[1] < 1:
        raise ValueError("paged_decode_attention: empty batch, pool or table")
    if window < 0:
        raise ValueError(f"paged_decode_attention: window {window} < 0")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Decode attention over a paged KV pool, on the card.

    q (B, H, Dh); k/v_pages (P, page, Hk, Dh); page_table (B, max_pages)
    int32; seq_lens (B,) int32 -> (B, H, Dh) in q's dtype.
    ``paged_decode_attention.launches`` counts launches.
    """
    check_inputs(q, k_pages, v_pages, page_table, seq_lens, window)
    lib = _library()
    b, h, dh = q.shape
    n_pool, page_size, hk, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, h, hk, dh, n_pool, page_size, page_table.shape[1], window,
            1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: launch failed "
                           f"(code {rc}) for q {tuple(q.shape)} "
                           f"{q.dtype}, pool {tuple(k_pages.shape)}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
