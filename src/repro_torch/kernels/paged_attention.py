"""Hopper paged decode-attention kernel: the Python wrapper.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro.kernels.paged_attention.paged_decode_attention`` (``_paged_kernel``,
``pl.pallas_call`` at ``src/repro/kernels/paged_attention.py:206``).  It is
CUDA C++ for ``sm_90a``, built by ``kernels.build`` and bound with
``ctypes``.  Its plain version is ``kernels.ref.paged_decode_attention_ref``.

Design (split-KV): each (row, kv head) pair is cut into ``n_split`` splits
of ``pages_per_split`` whole pages, chosen by :func:`split_plan` from the
table width and the card's SM count; the grid is ``(B * Hk, n_split)``.  A
split reads only its own pages that hold tokens of ``[lo, seq_len)``
(:func:`split_token_range` states which), copies them with ``cp.async``
into a shared-memory ring, scores them on the tensor cores (``mma.sync``,
bf16) or with float32 FMAs, and writes a float32 partial ``(m, l, o)``;
the split that finishes last for its pair (an atomic ticket) merges the
partials into the output, all in one launch.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
owns the per-device workspace (partials and the ticket counters, which
every launch leaves at zero), launches on the current stream and counts
the launch.  A captured decode step (``serving.step_graph``) sizes the
workspace up front (:func:`reserve_workspace`), pins it while it
captures (:func:`pinned`: a launch that would grow it raises) and keeps
the tensors it captured, so no graph ever holds a freed pointer.  The
kernel is instantiated for G in ``GROUP_SIZES``; any other G goes
through ``kernels.groups`` (zero query rows pad each group to a size the
kernel takes, G above 8 is cut into launches of 8, and the pad rows are
dropped), one counted launch each.  Anything the kernel does not
take raises — there is no fallback to the plain version.  ``_TUNED_PPB`` / ``tuned_pages_per_block``
of the TPU kernel are keyed to TPU VMEM and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, groups

HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)
PAGE_SIZES = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# split_plan: resident blocks wanted on each SM, and the split granularity
# (a bf16 block scores tiles of 64 tokens at Dh <= 128)
BLOCKS_PER_SM = 4
SPLIT_TOKENS = 64
MAX_SPLITS = 256            # the kernel's merge holds at most this many
MAX_SPLIT_PAGES = 1024      # and a block's page ids at most this many

_lib = None
# per CUDA device: SM count, and the (part_o, part_ml, tickets) workspace
_sms: Dict[torch.device, int] = {}
_workspace: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = {}
# devices whose workspace must not grow: a CUDA graph is being captured
# over it (``serving.step_graph``), and the graph keeps the pointers
_pinned: set = set()


def _library():
    global _lib
    if _lib is None:
        # repro-torch-audit: allow(retrace-jit) — memoised in _lib: one load a process (the strict auditor pins the library mid-serve)
        lib = build.load("paged_attention")
        fn = lib.paged_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_plan(max_pages: int, page_size: int, pairs: int,
               n_sm: int) -> Tuple[int, int]:
    """``(pages_per_split, n_split)`` for a launch over ``pairs`` (row, kv
    head) pairs and a table of ``max_pages`` slots on a card of ``n_sm``
    SMs: enough splits a pair that the grid holds about ``BLOCKS_PER_SM``
    blocks an SM, each split whole pages and a multiple of
    ``SPLIT_TOKENS`` tokens where the page is smaller, at most
    ``MAX_SPLITS`` splits of at most ``MAX_SPLIT_PAGES`` pages.  Every
    table slot falls in exactly one split: ``n_split * pages_per_split >=
    max_pages`` and no split is wholly past the table."""
    if min(max_pages, page_size, pairs, n_sm) < 1:
        raise ValueError("split_plan: every argument must be positive")
    if max_pages > MAX_SPLITS * MAX_SPLIT_PAGES:
        raise ValueError(f"split_plan: a table of {max_pages} pages is "
                         f"wider than {MAX_SPLITS} splits of "
                         f"{MAX_SPLIT_PAGES} pages")
    want = min(MAX_SPLITS, -(-BLOCKS_PER_SM * n_sm // pairs))   # a pair
    unit = max(1, SPLIT_TOKENS // page_size)           # pages
    pages = -(-max_pages // want)
    pages = min(max_pages, MAX_SPLIT_PAGES, -(-pages // unit) * unit)
    return pages, -(-max_pages // pages)


def split_token_range(seq_len: int, window: int, split: int,
                      pages_per_split: int, page_size: int,
                      max_pages: int) -> Tuple[int, int]:
    """Tokens ``[begin, end)`` that split ``split`` of a row reads (empty
    when ``end <= begin``): its whole pages intersected with ``[lo,
    seq_len)`` and the table, where ``lo = max(seq_len - window, 0)`` with
    a window and 0 without.  The kernel's ``split_range`` computes the
    same."""
    hi = min(seq_len, max_pages * page_size)
    lo = max(seq_len - window, 0) if window > 0 else 0
    span = pages_per_split * page_size
    return max(lo, split * span), min(hi, (split + 1) * span)


def workspace_sizes(batch: int, heads: int, kv_heads: int, head_dim: int,
                    max_pages: int, page_size: int,
                    n_sm: int) -> Tuple[int, int, int]:
    """``(part_o, part_ml, tickets)`` elements that every launch of one
    :func:`paged_decode_attention` call over these shapes needs: the
    largest of its launches (one a launch of the group plan, each over
    ``batch * kv_heads`` pairs split by :func:`split_plan`)."""
    _, n_split = split_plan(max_pages, page_size, batch * kv_heads, n_sm)
    g = max(padded for _, _, padded in
            groups.group_plan(heads // kv_heads, GROUP_SIZES))
    rows = batch * kv_heads * g * n_split       # (pair, split, head) rows
    return rows * head_dim, rows * 2, batch * kv_heads


def _scratch(device: torch.device, n_o: int, n_ml: int,
             pairs: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The device's workspace, grown to at least the sizes asked for.  The
    tickets start at zero and every launch leaves them at zero.  While the
    device's workspace is pinned (:func:`pinned`: a CUDA graph is being
    captured over it) a launch that needs more raises instead."""
    part_o, part_ml, tickets = _workspace.get(device, (None, None, None))
    grow = (part_o is None or part_o.numel() < n_o,
            part_ml is None or part_ml.numel() < n_ml,
            tickets is None or tickets.numel() < pairs)
    if any(grow) and device in _pinned:
        raise RuntimeError(
            f"paged_decode_attention: a launch needs a workspace of "
            f"({n_o}, {n_ml}, {pairs}) elements on {device}, more than the "
            f"pinned one ({_sizes(part_o, part_ml, tickets)}); a captured "
            "graph would keep the old pointers, so reserve_workspace must "
            "size it before the capture")
    if grow[0]:
        part_o = torch.empty(n_o, dtype=torch.float32, device=device)
    if grow[1]:
        part_ml = torch.empty(n_ml, dtype=torch.float32, device=device)
    if grow[2]:
        tickets = torch.zeros(pairs, dtype=torch.int32, device=device)
    _workspace[device] = (part_o, part_ml, tickets)
    return part_o, part_ml, tickets


def _sizes(*tensors) -> Tuple[int, ...]:
    return tuple(0 if t is None else t.numel() for t in tensors)


def _card(device) -> torch.device:
    """The workspace key of ``device``: a CUDA device with its index (the
    current card's for a bare ``cuda``), so ``cuda`` and ``cuda:0`` never
    make two workspaces on one card; another device as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def reserve_workspace(device, *, batch: int, heads: int, kv_heads: int,
                      head_dim: int, max_pages: int, page_size: int,
                      n_sm: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Grow ``device``'s workspace to what every launch over these shapes
    needs (:func:`workspace_sizes`, with the card's SM count unless
    ``n_sm`` is given) and return it.  A caller that captures launches in
    a CUDA graph calls this before the capture and keeps the returned
    tensors as long as the graph: a later growth puts new tensors in the
    device's slot and never frees the ones a graph holds."""
    dev = _card(device)
    if not n_sm:
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        n_sm = _sms[dev]
    return _scratch(dev, *workspace_sizes(batch, heads, kv_heads, head_dim,
                                          max_pages, page_size, n_sm))


def workspace(device) -> Tuple[torch.Tensor, ...]:
    """``device``'s workspace tensors as they are now (empty if none)."""
    return tuple(t for t in _workspace.get(_card(device), ())
                 if t is not None)


@contextlib.contextmanager
def pinned(device):
    """Within the block, no launch on ``device`` may grow its workspace: a
    launch that needs more raises (see :func:`_scratch`)."""
    dev = _card(device)
    if dev in _pinned:
        yield
        return
    _pinned.add(dev)
    try:
        yield
    finally:
        _pinned.discard(dev)


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
    if hk < 1 or h % hk:
        raise ValueError(f"paged_decode_attention: H={h} is not a multiple "
                         f"of Hk={hk}")
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
    hk = k_pages.shape[2]
    plan = groups.group_plan(q.shape[1] // hk, GROUP_SIZES)
    if len(plan) == 1 and plan[0][1] == plan[0][2]:
        return _launch(q, k_pages, v_pages, page_table, seq_lens, window)
    outs = [_launch(qi, k_pages, v_pages, page_table, seq_lens, window)
            for qi in groups.split_groups(q, hk, plan, 1)]
    return groups.merge_groups(outs, hk, plan, 1)


def _launch(q, k_pages, v_pages, page_table, seq_lens, window: int
            ) -> torch.Tensor:
    """One kernel launch, at a group size in ``GROUP_SIZES``."""
    lib = _library()
    b, h, dh = q.shape
    n_pool, page_size, hk, _ = k_pages.shape
    max_pages = page_table.shape[1]
    # the workspace and the SM count are kept per card, keyed by a device
    # with its index (a tensor's always has one), so ``cuda`` and
    # ``cuda:0`` never make two workspaces on one card
    dev = _card(q.device)
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    pages, n_split = split_plan(max_pages, page_size, b * hk, _sms[dev])
    part_o, part_ml, tickets = _scratch(dev, b * h * n_split * dh,
                                        b * h * n_split * 2, b * hk)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
            b, h, hk, dh, n_pool, page_size, max_pages, window, pages,
            n_split, 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: launch failed "
                           f"(code {rc}) for q {tuple(q.shape)} "
                           f"{q.dtype}, pool {tuple(k_pages.shape)}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
