"""Paged KV cache: shared page pools, per-slot rings and recurrent states,
and the host-side page-table allocator (counterpart of
``repro.serving.kv_cache``).

Device state is one ``(P, page, Hk, Dh)`` K pool and V pool per paged
attention layer (``"attn"``/``"global"``) plus one ``(batch, max_pages)``
int32 page table shared by every paged layer, one ring of
``window_size`` slots per row for each sliding-window (``"local"``) layer,
and one recurrent state per row for each ``"rglru"`` layer (``h`` and the
conv's trailing inputs).  An arch with no paged layer (recurrentgemma)
still has the table, which the allocator's bookkeeping fills, and no
pool.  Bookkeeping (free list, per-slot page lists) is host Python.  The
port has local pages only: the global pools of the §4.2 offloader come
with the offload slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import Runtime, resolve_device
from repro_torch.models.model import PAGED_KINDS, _kind_cache, \
    check_supported


@dataclass(frozen=True)
class PoolConfig:
    page_size: int = 16
    n_local_pages: int = 64           # shared by all microbatches
    n_global_pages: int = 0           # per global pool (offload slice)
    max_pages_per_seq: int = 16

    @property
    def n_pages(self) -> int:
        return self.n_local_pages + 2 * self.n_global_pages


class PageAllocator:
    """Host-side free-list allocator over the local page ids.

    Page 0 is reserved as a *scratch* page: released and parked slots'
    table rows point at it, so the (discarded) decode writes of inactive
    rows can never corrupt a page that belongs to a live sequence.
    Releasing a slot twice, or a page that is already free, raises."""

    def __init__(self, pool: PoolConfig):
        if pool.n_local_pages < 2:
            raise ValueError("need >= 2 local pages (page 0 is scratch)")
        if pool.n_global_pages:
            raise NotImplementedError(
                "global page pools come with the offload slice of the port")
        self.pool = pool
        self._free: List[int] = list(range(1, pool.n_local_pages))
        self._seq_pages: Dict[int, List[int]] = {}

    def pages_of(self, slot: int) -> List[int]:
        return list(self._seq_pages.get(slot, ()))

    def allocate(self, slot: int, n_pages: int) -> List[int]:
        """Allocate ``n_pages`` for ``slot``; MemoryError when exhausted
        (nothing is granted then)."""
        if n_pages > len(self._free):
            raise MemoryError(f"page pool exhausted: need {n_pages}, "
                              f"free={len(self._free)}")
        got = [self._free.pop() for _ in range(n_pages)]
        self._seq_pages.setdefault(slot, []).extend(got)
        return got

    def extend(self, slot: int) -> int:
        return self.allocate(slot, 1)[0]

    def release(self, slot: int) -> None:
        if slot not in self._seq_pages:
            raise KeyError(f"release: slot {slot} owns no pages (double "
                           "release, or a slot that was never allocated)")
        for p in self._seq_pages.pop(slot):
            if p in self._free:
                raise ValueError(f"page {p} returned to the free list twice")
            self._free.append(p)

    def table_row(self, slot: int) -> np.ndarray:
        row = np.zeros((self.pool.max_pages_per_seq,), np.int32)
        pages = self._seq_pages.get(slot, ())
        row[: len(pages)] = pages
        return row


def build_paged_caches(cfg: ModelConfig, batch: int, pool: PoolConfig,
                       rt: Runtime, device=None) -> dict:
    """Engine caches on ``device`` (``cuda`` unless asked): zeroed pools for
    the paged kinds, empty rings (``pos`` -1) of ``window_size`` slots for
    ``"local"``, zero recurrent states for ``"rglru"``, and a zero
    (scratch-parked) table."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (pool.n_pages, pool.page_size, cfg.num_kv_heads, cfg.head_dim)

    def layer(kind: str) -> dict:
        if kind in PAGED_KINDS:
            return {"k_pages": torch.zeros(shape, dtype=rt.compute_dtype,
                                           device=device),
                    "v_pages": torch.zeros(shape, dtype=rt.compute_dtype,
                                           device=device)}
        cap = cfg.window_size if kind == "local" and cfg.window_size else \
            pool.max_pages_per_seq * pool.page_size
        return _kind_cache(kind, cfg, batch, cap, rt, device)

    table = torch.zeros((batch, pool.max_pages_per_seq), dtype=torch.int32,
                        device=device)
    return {"layers": [layer(k) for k in cfg.layer_kinds()],
            "page_table": table}


def set_page_table(caches: dict, table: np.ndarray) -> dict:
    """Copy the host page table (batch, max_pages) into the device table,
    in place."""
    caches["page_table"].copy_(torch.from_numpy(
        np.ascontiguousarray(table, dtype=np.int32)))
    return caches


def reset_slot(caches: dict, slot: int) -> dict:
    """Clear a slot's per-row state when it is reassigned, in place: ring
    positions back to -1, recurrent states (``h``, ``conv``) back to
    zeros, as ``repro.serving.kv_cache.reset_slot`` does.  Paged pools
    need no clearing (validity is governed by the sequence lengths)."""
    for layer in caches["layers"]:
        if "pos" in layer:
            layer["pos"][slot] = -1
        elif "h" in layer:
            layer["h"][slot] = 0.0
            layer["conv"][slot] = 0.0
    return caches


def slot_view(caches: dict, start: int, size: int) -> dict:
    """A ``size``-row view of the batch starting at ``start``: the page
    table rows and each ring's and recurrent state's rows are views (no
    copy), the shared pools pass through whole.  The model writes pools,
    rings and states in place, so nothing is merged back."""
    def rows(layer: dict) -> dict:
        if "k_pages" in layer:
            return layer
        return {name: t[start:start + size] for name, t in layer.items()}
    return {"layers": [rows(layer) for layer in caches["layers"]],
            "page_table": caches["page_table"][start:start + size]}
