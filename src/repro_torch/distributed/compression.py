"""Compression for slow links (counterpart of
``repro.distributed.compression``): the int8 wire codec of the §4.3
pipeline's stage boundary, and the gradient compressors of data-parallel
training.

``int8_compress_rows`` quantizes each row of the trailing axis to int8 with
one float32 scale a row; ``int8_decompress_rows`` inverts it;
``int8_wire_bytes`` is the packed payload's size, the formula
``distributed.transport.CompressedTransport`` prices the wire with (top-k
pricing of activations is only a byte formula in the transport).

For gradients: ``int8_compress`` quantizes a whole tensor with one scale;
``topk_compress`` keeps the ``frac`` largest magnitudes with their flat
indices; ``Compressor`` runs either over a gradient tree with error
feedback (each step's residual is added back the next step, so the
compression noise stays O(1) over training), and prices the wire
(``wire_bytes``, ``compression_ratio``).  ``roundtrip`` is compress ->
decompress, what the training step applies before the optimizer.  The
residual is allocated once (``prime``, or the first round) and each
round writes the new one into it, so a captured training step, which
reads and writes fixed addresses, carries the error feedback from one
replay to the next as the eager loop does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like

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


def int8_compress(x: torch.Tensor):
    """Per-tensor symmetric int8: ``(q int8, scale float32 scalar)`` with
    ``scale = max(max|x|, 1e-12) / 127``, rounding half to even."""
    xf = x.float()
    scale = xf.abs().max().clamp(min=1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_compress(x: torch.Tensor, frac: float):
    """The ``max(1, int(numel * frac))`` entries of largest magnitude:
    ``(values float32, flat indices, shape)``.  Among equal magnitudes the
    lower index comes first (a stable descending sort), as
    ``jax.lax.top_k`` orders them."""
    xf = x.float().reshape(-1)
    k = max(1, int(xf.numel() * frac))
    idx = torch.sort(xf.abs(), descending=True, stable=True).indices[:k]
    return xf[idx], idx, tuple(x.shape)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    out = torch.zeros(int(torch.Size(shape).numel()), dtype=torch.float32,
                      device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


@dataclass
class Compressor:
    """Error-feedback compressor over gradient trees."""
    method: str = "int8"              # int8 | topk | none
    topk_frac: float = 0.01
    error_feedback: bool = True
    _residual: Any = None

    def wire_bytes(self, grads) -> int:
        """Bytes a round of ``grads`` puts on the wire: int8 one byte an
        element and a float32 scale a tensor; top-k a float32 value and an
        int32 index a kept entry; uncompressed the tensors themselves."""
        total = 0
        for leaf in leaves(grads):
            n = leaf.numel()
            if self.method == "int8":
                total += n + 4
            elif self.method == "topk":
                total += max(1, int(n * self.topk_frac)) * 8
            else:
                total += n * leaf.element_size()
        return total

    def prime(self, grads) -> None:
        """Allocate the zero residual like ``grads`` (a tree of their
        shapes and devices) if there is none yet: before a training step
        is captured, so the graph reads and writes this residual."""
        if self._residual is None and self.error_feedback and \
                self.method != "none":
            self._residual = tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)

    def roundtrip(self, grads):
        """compress -> decompress of every leaf, the residual of the
        previous round added first (error feedback) and the new residual
        written into the residual's own tensors, a leaf at a time; the
        outputs in each gradient's dtype."""
        if self.method == "none":
            return grads
        self.prime(grads)

        def one(g, r):
            gf = g.float() + (r if r is not None else 0.0)
            if self.method == "int8":
                out = int8_decompress(*int8_compress(gf))
            else:
                out = topk_decompress(*topk_compress(gf, self.topk_frac))
            return out.to(g.dtype), gf - out

        if not self.error_feedback:
            return tree_map(lambda g: one(g, None)[0], grads)
        outs = []
        for g, r in zip(leaves(grads), leaves(self._residual)):
            out, new_r = one(g, r)
            r.copy_(new_r)
            outs.append(out)
        return unflatten_like(grads, outs)

    def compression_ratio(self, grads) -> float:
        """float32 bytes of ``grads`` over its wire bytes."""
        raw = sum(l.numel() * 4 for l in leaves(grads))
        return raw / max(self.wire_bytes(grads), 1)
