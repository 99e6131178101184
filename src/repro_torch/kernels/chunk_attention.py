"""Hopper chunked-prefill attention over the page pool: the Python wrapper.

The kernel (``csrc/chunk_attention.cu``) replaces no TPU kernel: the JAX
package's chunk attention is plain ``jnp``
(``repro.models.attention.chunk_attention``).  It computes that function
straight from the pool, for a prefill chunk's queries against their rows'
page tables: no gather of the table, no score matrix in device memory.  It
is CUDA C++ for ``sm_90a``, built by ``kernels.build`` and bound with
``ctypes``.  Its plain version is ``kernels.ref.paged_chunk_attention_ref``
(the gather and ``models.attention.chunk_attention``).

Design: bf16 runs one warp-specialised kernel per Dh: a block owns 128
score rows (128 / G positions of one row x the G heads of one kv head);
one producer thread loads the Q tile and a ring of 64-key K/V tiles
through TMA, each tile in boxes of one page's rows at the page id the
block read once from the table; two consumer warpgroups run both products
on ``wgmma`` (P rounded to bf16, as the plain version rounds it) with an
online softmax.  A block walks keys only up to its largest query position
and masks only the tiles on the chunk's diagonal.  float32 runs scalar
FMAs.  A padded query (position < 0) gets the plain version's value, the
mean of V over its row's whole table.  No workspace, so nothing for a
captured graph to pin.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches on the current stream and counts the launch.  The kernel takes G
in ``GROUP_SIZES`` (a run-time argument); any other G goes through
``kernels.groups``, one counted launch each.  Anything the kernel does not
take raises, ``window > 0`` included (no paged layer has a window) —
there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, groups

HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8, 16)
PAGE_SIZES = (8, 16, 32, 64, 128)
MAX_TABLE_PAGES = 4096      # the page ids a block keeps in shared memory
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library():
    global _lib
    if _lib is None:
        # a paged model's serve needs the decode kernel too: one nvcc each,
        # in parallel, so the first build takes the longer of the two
        # repro-torch-audit: allow(retrace-jit) — memoised in _lib: one build a process
        build.build_many(("chunk_attention", "paged_attention"))
        # repro-torch-audit: allow(retrace-jit) — memoised in _lib: one load a process (the strict auditor pins the library mid-serve)
        lib = build.load("chunk_attention")
        fn = lib.paged_chunk_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(q, k_pages, v_pages, page_table, q_pos, window: int):
    """Raise ``ValueError`` for anything the kernel does not take: the
    window, dtypes and shapes first, then where the tensors lie."""
    if window != 0:
        raise ValueError(f"paged_chunk_attention: window {window}; the "
                         "kernel attends whole tables (no paged layer has a "
                         "window)")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_chunk_attention: dtype {q.dtype} not "
                         "supported (bfloat16 or float32)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_chunk_attention: q, k_pages and v_pages "
                         "must share one dtype")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError("paged_chunk_attention: page_table and q_pos must "
                         "be int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_chunk_attention: want q (B,C,H,Dh) and "
                         "k/v_pages (P,page,Hk,Dh) of one shape")
    b, c, h, dh = q.shape
    n_pool, page_size, hk, dh_k = k_pages.shape
    if dh_k != dh or dh not in HEAD_DIMS:
        raise ValueError(f"paged_chunk_attention: head_dim {dh} (pool "
                         f"{dh_k}) not in {HEAD_DIMS}")
    if hk < 1 or h % hk:
        raise ValueError(f"paged_chunk_attention: H={h} is not a multiple "
                         f"of Hk={hk}")
    if page_size not in PAGE_SIZES:
        raise ValueError(f"paged_chunk_attention: page size {page_size} "
                         f"not in {PAGE_SIZES}")
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            q_pos.shape != (b, c):
        raise ValueError("paged_chunk_attention: want page_table (B, "
                         "max_pages) and q_pos (B, C)")
    if b < 1 or c < 1 or n_pool < 1 or page_table.shape[1] < 1:
        raise ValueError("paged_chunk_attention: empty batch, chunk, pool "
                         "or table")
    if page_table.shape[1] > MAX_TABLE_PAGES:
        raise ValueError(f"paged_chunk_attention: a table of "
                         f"{page_table.shape[1]} pages is wider than "
                         f"{MAX_TABLE_PAGES}")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "q_pos": q_pos}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_chunk_attention: {name} is on "
                             f"{t.device}, the kernel needs every input on "
                             f"the same CUDA device as q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"paged_chunk_attention: {name} must be "
                             "contiguous")
        if name in ("q", "k_pages", "v_pages") and t.data_ptr() % 16:
            raise ValueError(f"paged_chunk_attention: {name} must be "
                             "16-byte aligned")


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          q_pos: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """A prefill chunk's attention over a paged KV pool, on the card.

    q (B, C, H, Dh); k/v_pages (P, page, Hk, Dh); page_table (B,
    max_pages) int32; q_pos (B, C) int32 absolute positions, -1 padded ->
    (B, C, H, Dh) in q's dtype.  Query ``i`` of a row sees the slots ``t
    <= q_pos[i]`` of the row's table, slot ``t`` holding position ``t``.
    ``paged_chunk_attention.launches`` counts launches.
    """
    check_inputs(q, k_pages, v_pages, page_table, q_pos, window)
    hk = k_pages.shape[2]
    plan = groups.group_plan(q.shape[2] // hk, GROUP_SIZES)
    if len(plan) == 1 and plan[0][1] == plan[0][2]:
        return _launch(q, k_pages, v_pages, page_table, q_pos)
    outs = [_launch(qi, k_pages, v_pages, page_table, q_pos)
            for qi in groups.split_groups(q, hk, plan, 2)]
    return groups.merge_groups(outs, hk, plan, 2)


def _launch(q, k_pages, v_pages, page_table, q_pos) -> torch.Tensor:
    """One kernel launch, at a group size in ``GROUP_SIZES``."""
    lib = _library()
    b, c, h, dh = q.shape
    n_pool, page_size, hk, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_chunk_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
            b, c, h, hk, dh, n_pool, page_size, page_table.shape[1], 0,
            1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_chunk_attention: launch failed (code "
                           f"{rc}) for q {tuple(q.shape)} {q.dtype}, pool "
                           f"{tuple(k_pages.shape)}, table "
                           f"{tuple(page_table.shape)}")
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0
