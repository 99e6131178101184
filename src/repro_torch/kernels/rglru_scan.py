"""Hopper RG-LRU scan kernel: the Python wrapper.

The kernel (``csrc/rglru_scan.cu``) replaces the TPU kernel
``repro.kernels.rglru_scan.rglru_scan_pallas`` (``pl.pallas_call`` at
``src/repro/kernels/rglru_scan.py:54``, kernel body ``_rglru_kernel``).  It
is CUDA C++ for ``sm_90a``, built by ``kernels.build`` and bound with
``ctypes``.  Its plain version is ``kernels.ref.rglru_scan_ref``.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches on the current stream and counts the launch.  Anything the kernel
does not take raises — there is no fallback to the plain version.  The
kernel takes every B from 1 to 65,535 and every S from 1; it takes Dr only
as a multiple of 4, and ``a`` and ``b`` only at 16-byte aligned addresses,
because it loads them through TMA tensor maps, whose row stride (Dr · 4
bytes) and base must be multiples of 16 bytes.  The TPU kernel's
``s_blk`` / ``d_blk`` size its VMEM blocks and have no counterpart here: a
lane carries one channel over the whole sequence, fed from a ring of
64-step tiles in shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("rglru_scan")
        fn = lib.rglru_scan
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(a, b, h0) -> None:
    """Raise ``ValueError`` for anything the kernel does not take; the
    shape rules are checked first, on any device."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: want a and b (B, S, Dr) of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    bsz, s, dr = a.shape
    if min(bsz, s, dr) < 1 or bsz > 65535:
        raise ValueError(f"rglru_scan: shape {tuple(a.shape)}: B, S and Dr "
                         "must be at least 1, and B at most 65535")
    if dr % 4:
        raise ValueError(f"rglru_scan: Dr = {dr} must be a multiple of 4: "
                         "TMA loads a and b, and a tensor map's row stride "
                         "(Dr * 4 bytes) must be a multiple of 16 bytes")
    if h0 is not None and h0.shape != (bsz, dr):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)}, want "
                         f"{(bsz, dr)}")
    tensors = {"a": a, "b": b}
    if h0 is not None:
        tensors["h0"] = h0
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, the "
                             "kernel needs every input on the same CUDA "
                             f"device as a ({a.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan: {name} is {t.dtype}, the kernel "
                             "takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    for name, t in (("a", a), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"rglru_scan: {name} starts at an address that "
                             "is not a multiple of 16 bytes, as a TMA tensor "
                             "map's base must be")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1, on the card.

    a, b (B, S, Dr) float32; h0 (B, Dr) float32 or None (zeros) -> every
    h_t (B, S, Dr) float32.  ``rglru_scan.launches`` counts launches.
    """
    check_inputs(a, b, h0)
    lib = _library()
    bsz, s, dr = a.shape
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan(a.data_ptr(), b.data_ptr(),
                            None if h0 is None else h0.data_ptr(),
                            out.data_ptr(), bsz, s, dr, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: launch failed (code {rc}) for "
                           f"a {tuple(a.shape)}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
