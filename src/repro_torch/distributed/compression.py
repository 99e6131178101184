"""The int8 wire codec of the §4.3 pipeline's stage boundary (counterpart of
``repro.distributed.compression``'s row codec).

``int8_compress_rows`` quantizes each row of the trailing axis to int8 with
one float32 scale a row; ``int8_decompress_rows`` inverts it;
``int8_wire_bytes`` is the packed payload's size, the formula
``distributed.transport.CompressedTransport`` prices the wire with.  The
gradient compressors of the JAX module (``int8_compress`` over a whole
tensor, ``topk_*``, ``Compressor``) come with the training slice; top-k
pricing of activations is only a byte formula in the transport.
"""

from __future__ import annotations

import torch

# below float32's maximum: 127 * (amax / 127) can round one ulp past amax,
# so amax = finfo.max would decompress to inf
INF_CAP = 3.0e38


def int8_compress_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization: ``(q int8, scale (..., 1)
    float32)``.  Non-finite inputs are clamped first (NaN to 0, +-inf to
    +-``INF_CAP``) so one bad row cannot poison its scale and the round
    trip stays finite; the values round half to even, as ``jnp.round``
    does."""
    xf = torch.nan_to_num(x.float(), nan=0.0, posinf=INF_CAP,
                          neginf=-INF_CAP)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_decompress_rows(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_wire_bytes(n_elems: int, n_rows: int) -> int:
    """Bytes of the packed per-row payload: 1 B an element plus one float32
    scale a row — what the pipeline's wire carries, and what
    ``CompressedTransport`` books."""
    return int(n_elems) + 4 * int(n_rows)
