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
pool.  Bookkeeping (free lists, per-slot page lists) is host Python.

The page id space of each pool is partitioned as DeServe §4.2 lays it out:

      [0, n_local)                               local pages (never offloaded)
      [n_local, n_local + n_global)              global pool G0
      [n_local + n_global, n_local + 2 n_global) global pool G1

Microbatch ``m`` draws its overflow pages from ``G_{m % 2}``; the
double-buffer offloader (``repro_torch.core.offload``) keeps the pool of
the microbatch that is not computing in host memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

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

    def global_range(self, pool_id: int) -> range:
        s = self.n_local_pages + pool_id * self.n_global_pages
        return range(s, s + self.n_global_pages)


class PageAllocator:
    """Host-side free-list allocator over the partitioned page id space.

    Page 0 is reserved as a *scratch* page: released and parked slots'
    table rows point at it, so the (discarded) decode writes of inactive
    rows can never corrupt a page that belongs to a live sequence.
    Releasing a slot twice, or a page that is already free, raises.

    There is one free list per global-pool parity, as in
    ``repro.serving.kv_cache.PageAllocator``: microbatches ``m`` and
    ``m + 2`` draw from the same list although the offloader swaps the
    whole parity slice between them, so a microbatch's global capacity is
    ``n_global / (N_B / 2)`` pages, not Formula 1's ``M_G``.  The port
    keeps the reference's behaviour (ROADMAP Queue 3) so that the two stay
    comparable; refcounts and the prefix cache come with the
    online-serving slice."""

    def __init__(self, pool: PoolConfig):
        if pool.n_local_pages < 2:
            raise ValueError("need >= 2 local pages (page 0 is scratch)")
        self.pool = pool
        self._free_local: List[int] = list(range(1, pool.n_local_pages))
        self._free_global: Dict[int, List[int]] = {
            0: list(pool.global_range(0)), 1: list(pool.global_range(1))}
        self._seq_pages: Dict[int, List[int]] = {}

    def free_local(self) -> int:
        return len(self._free_local)

    def free_global(self, pool_id: int) -> int:
        return len(self._free_global[pool_id])

    def pages_of(self, slot: int) -> List[int]:
        return list(self._seq_pages.get(slot, ()))

    def allocate(self, slot: int, n_pages: int, *,
                 global_pool: Optional[int] = None) -> List[int]:
        """Allocate ``n_pages`` for ``slot``: local pages first, the
        overflow from ``global_pool`` (if given).  MemoryError when
        exhausted (nothing is granted then)."""
        got: List[int] = []
        while len(got) < n_pages and self._free_local:
            got.append(self._free_local.pop())
        while len(got) < n_pages and global_pool is not None and \
                self._free_global[global_pool]:
            got.append(self._free_global[global_pool].pop())
        if len(got) < n_pages:
            for p in got:                   # roll back
                self._give_back(p)
            raise MemoryError(
                f"page pool exhausted: need {n_pages}, got {len(got)} "
                f"(local free={self.free_local()}, "
                f"global={ {i: self.free_global(i) for i in (0, 1)} })")
        self._seq_pages.setdefault(slot, []).extend(got)
        return got

    def extend(self, slot: int, *, global_pool: Optional[int] = None) -> int:
        return self.allocate(slot, 1, global_pool=global_pool)[0]

    def release(self, slot: int) -> None:
        if slot not in self._seq_pages:
            raise KeyError(f"release: slot {slot} owns no pages (double "
                           "release, or a slot that was never allocated)")
        for p in self._seq_pages.pop(slot):
            self._give_back(p)

    def _give_back(self, p: int) -> None:
        if p < self.pool.n_local_pages:
            target = self._free_local
        elif p in self.pool.global_range(0):
            target = self._free_global[0]
        else:
            target = self._free_global[1]
        if p in target:
            raise ValueError(f"page {p} returned to the free list twice")
        target.append(p)

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


def kv_bytes_per_page(cfg: ModelConfig, pool: PoolConfig,
                      dtype_bytes: int = 2) -> int:
    """Bytes one page occupies across all paged layers (k + v)."""
    n_paged = sum(1 for k in cfg.layer_kinds() if k in PAGED_KINDS)
    return (2 * n_paged * pool.page_size * cfg.num_kv_heads * cfg.head_dim
            * dtype_bytes)


def global_slice(pool: PoolConfig, pool_id: int) -> slice:
    r = pool.global_range(pool_id)
    return slice(r.start, r.stop)


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
