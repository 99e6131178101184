"""Paged KV cache: shared page pools, per-slot rings and recurrent states,
and the host-side page-table allocator (counterpart of
``repro.serving.kv_cache``).

Device state is one ``(P, page, Hk, Dh)`` K pool and V pool per paged
attention layer (``"attn"``/``"global"``) plus one ``(batch, max_pages)``
int32 page table shared by every paged layer (one copy a device when the
layers are placed on several by pipeline stage), one ring of
``window_size`` slots per row for each sliding-window (``"local"``) layer,
and one recurrent state per row for each recurrent layer (``"rglru"``:
``h`` and the conv's trailing inputs; ``"mlstm"``: ``c``, ``n``, ``m``;
``"slstm"``: ``c``, ``n``, ``h``, ``m``).  An arch with no paged layer
(recurrentgemma, xlstm) still has the table, which the allocator's
bookkeeping fills, and no pool.  Bookkeeping (free lists, per-slot page lists, page refcounts and
the prefix-block index of :class:`PrefixCache`) is host Python.

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
from repro_torch.models.model import PAGED_KINDS, _kind_cache


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

    Pages are **refcounted**: a page may be owned by several slots at once
    (the prefix cache shares fully-prefilled prompt blocks) and retained
    by the :class:`PrefixCache` on top, so ``release`` *decrements* and a
    page returns to its free list only when its last owner lets go.
    Releasing a slot that owns nothing, or returning a page that is
    already free, raises: a silent double free would sooner or later
    grant one page to two live sequences.

    There is one free list per global-pool parity, as in
    ``repro.serving.kv_cache.PageAllocator``: microbatches ``m`` and
    ``m + 2`` draw from the same list although the offloader swaps the
    whole parity slice between them, so a microbatch's global capacity is
    ``n_global / (N_B / 2)`` pages, not Formula 1's ``M_G``.  The port
    keeps the reference's behaviour (ROADMAP Queue 3) so that the two stay
    comparable."""

    def __init__(self, pool: PoolConfig):
        if pool.n_local_pages < 2:
            raise ValueError("need >= 2 local pages (page 0 is scratch)")
        self.pool = pool
        self._free_local: List[int] = list(range(1, pool.n_local_pages))
        self._free_global: Dict[int, List[int]] = {
            0: list(pool.global_range(0)), 1: list(pool.global_range(1))}
        self._seq_pages: Dict[int, List[int]] = {}
        # page -> owners (slots listing it + one per cache retain); a page
        # is in _refs iff it is on no free list
        self._refs: Dict[int, int] = {}

    def free_local(self) -> int:
        return len(self._free_local)

    def free_global(self, pool_id: int) -> int:
        return len(self._free_global[pool_id])

    def pages_of(self, slot: int) -> List[int]:
        return list(self._seq_pages.get(slot, ()))

    def refcount(self, p: int) -> int:
        return self._refs.get(p, 0)

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
            for p in got:                   # roll back (never granted)
                self._give_back(p)
            raise MemoryError(
                f"page pool exhausted: need {n_pages}, got {len(got)} "
                f"(local free={self.free_local()}, "
                f"global={ {i: self.free_global(i) for i in (0, 1)} })")
        for p in got:
            self._refs[p] = 1
        self._seq_pages.setdefault(slot, []).extend(got)
        return got

    def extend(self, slot: int, *, global_pool: Optional[int] = None) -> int:
        return self.allocate(slot, 1, global_pool=global_pool)[0]

    def adopt(self, slot: int, pages: List[int]) -> None:
        """Bind already-owned ``pages`` to ``slot`` as a shared prefix: each
        page's refcount goes up, nothing is taken from a free list.  It must
        come before ``allocate`` for the slot, so that the shared pages head
        its table row (page ``i`` holds positions ``[i * page_size,
        (i + 1) * page_size)``)."""
        if self._seq_pages.get(slot):
            raise ValueError(
                f"adopt: slot {slot} already owns pages "
                f"{self._seq_pages[slot]} — shared prefix pages must come "
                "first in the table row")
        for p in pages:
            if p not in self._refs:
                raise ValueError(
                    f"adopt: page {p} is not currently owned — a free page "
                    "cannot be shared (stale prefix-cache entry?)")
        for p in pages:
            self._refs[p] += 1
        self._seq_pages[slot] = list(pages)

    def retain(self, p: int) -> None:
        """Add a non-slot owner (the prefix cache) to an owned page."""
        if p not in self._refs:
            raise ValueError(f"retain: page {p} is not currently owned")
        self._refs[p] += 1

    def drop(self, p: int) -> bool:
        """Release a ``retain`` reference; True when the page went back to
        its free list (it was the last owner)."""
        return self._decref(p)

    def release(self, slot: int) -> None:
        """Release every page ``slot`` owns (shared pages stay live for
        their other owners).  A slot that owns nothing raises: the engine
        frees once per occupied slot, so a second release is a bookkeeping
        fault, not a no-op."""
        if slot not in self._seq_pages:
            raise KeyError(f"release: slot {slot} owns no pages (double "
                           "release, or a slot that was never allocated)")
        for p in self._seq_pages.pop(slot):
            self._decref(p)

    def _decref(self, p: int) -> bool:
        n = self._refs.get(p)
        if n is None:
            raise ValueError(f"page {p} released but not owned (double "
                             "free)")
        if n > 1:
            self._refs[p] = n - 1
            return False
        del self._refs[p]
        self._give_back(p)
        return True

    def _give_back(self, p: int) -> None:
        if p < self.pool.n_local_pages:
            target = self._free_local
        elif p in self.pool.global_range(0):
            target = self._free_global[0]
        else:
            target = self._free_global[1]
        if p in target:
            raise ValueError(f"page {p} returned to the free list twice — a "
                             "later allocate would grant one page to two "
                             "sequences")
        target.append(p)

    def table_row(self, slot: int) -> np.ndarray:
        row = np.zeros((self.pool.max_pages_per_seq,), np.int32)
        pages = self._seq_pages.get(slot, ())
        row[: len(pages)] = pages
        return row


@dataclass
class _PrefixEntry:
    page: int
    children: int = 0                 # longer cached prefixes extending it
    last_use: int = 0                 # LRU clock (lookups and inserts)


class PrefixCache:
    """Prefix-block index over the paged KV pools (host side).

    Requests that share a system prompt hit the same pages instead of
    prefilling them again: the index maps each *full-page* token prefix
    (the exact token tuple, a chain of ``page_size`` blocks) to the page
    that holds its KV.  Paged attention's KV at position ``t`` is a
    function of ``tokens[:t + 1]`` alone, so blocks written by different
    slots for the same prefix are interchangeable.

    Only **local** pages are registered: a global page's content is swapped
    per microbatch by the §4.2 offloader, so a share across microbatches
    would be overwritten by the next swap.  A match is capped at
    ``(len(prompt) - 1) // page_size`` pages: the last prompt position is
    always prefilled, for the first token's logits.  Each cached page
    holds one ``PageAllocator.retain`` reference; LRU leaf eviction
    (``evict``) drops them when the pool runs dry."""

    def __init__(self, alloc: PageAllocator):
        self.alloc = alloc
        self.page_size = alloc.pool.page_size
        self.n_local_pages = alloc.pool.n_local_pages
        self._entries: Dict[tuple, _PrefixEntry] = {}
        self._clock = 0
        self.hit_requests = 0
        self.miss_requests = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def pages_retained(self) -> List[int]:
        """Pages the cache holds a retain reference on (one an entry)."""
        return [e.page for e in self._entries.values()]

    def match(self, prompt: List[int]) -> List[int]:
        """Pages covering the longest cached full-page prefix of
        ``prompt`` (possibly none), in table-row order."""
        self._clock += 1
        pages: List[int] = []
        for i in range((len(prompt) - 1) // self.page_size):
            e = self._entries.get(tuple(prompt[: (i + 1) * self.page_size]))
            if e is None:
                break
            e.last_use = self._clock
            pages.append(e.page)
        if pages:
            self.hit_requests += 1
            self.hit_tokens += len(pages) * self.page_size
        else:
            self.miss_requests += 1
        return pages

    def insert(self, prompt: List[int], pages: List[int]) -> int:
        """Register a fully prefilled sequence's prompt blocks (``pages`` in
        table-row order).  An existing entry wins: two requests that
        prefilled the same prefix side by side keep the first one's page.
        Stops at the first global page.  Returns the pages newly
        retained."""
        self._clock += 1
        added = 0
        parent: Optional[_PrefixEntry] = None
        for i in range(min((len(prompt) - 1) // self.page_size, len(pages))):
            key = tuple(prompt[: (i + 1) * self.page_size])
            e = self._entries.get(key)
            if e is None:
                p = pages[i]
                if p >= self.n_local_pages:
                    break       # a global page is swapped per microbatch
                self.alloc.retain(p)
                e = _PrefixEntry(page=p, last_use=self._clock)
                self._entries[key] = e
                if parent is not None:
                    parent.children += 1
                added += 1
            else:
                e.last_use = self._clock
            parent = e
        return added

    def evict(self, n_pages: int) -> int:
        """Drop least recently used *leaf* entries until ``n_pages`` pages
        went back to the free lists (an entry whose page a live slot still
        shares frees nothing) or the cache is empty.  Returns the pages
        freed."""
        freed = 0
        while freed < n_pages and self._entries:
            key = min((k for k, e in self._entries.items()
                       if e.children == 0),
                      key=lambda k: self._entries[k].last_use)
            e = self._entries.pop(key)
            if len(key) > self.page_size:
                parent = self._entries.get(key[:-self.page_size])
                if parent is not None:
                    parent.children -= 1
            if self.alloc.drop(e.page):
                freed += 1
            self.evictions += 1
        return freed

    def clear(self) -> int:
        """Drop every entry; returns the pages freed."""
        return self.evict(len(self._entries) + 1) if self._entries else 0

    @property
    def hit_rate(self) -> float:
        total = self.hit_requests + self.miss_requests
        return self.hit_requests / total if total else 0.0


def build_paged_caches(cfg: ModelConfig, batch: int, pool: PoolConfig,
                       rt: Runtime, device=None, layer_devices=None) -> dict:
    """Engine caches on ``device`` (``cuda`` unless asked): zeroed pools for
    the paged kinds, empty rings (``pos`` -1) of ``window_size`` slots for
    ``"local"``, zero recurrent states for the recurrent kinds, and a zero
    (scratch-parked) table.

    ``layer_devices`` (one device a layer, ``core.pipeline.layer_devices``,
    carrying card indices) places them by pipeline stage: each layer's
    pools, ring or state on its device, ``"page_table"`` on ``device``
    (stage 0's), and, when the layers span several devices, one more copy
    of the table on each under ``"page_tables"`` (device -> table, stage
    0's included), which :func:`set_page_table` keeps equal."""
    device = resolve_device(device)
    devs = [device] * cfg.num_layers if layer_devices is None \
        else list(layer_devices)
    shape = (pool.n_pages, pool.page_size, cfg.num_kv_heads, cfg.head_dim)

    def layer(kind: str, dev) -> dict:
        if kind in PAGED_KINDS:
            return {"k_pages": torch.zeros(shape, dtype=rt.compute_dtype,
                                           device=dev),
                    "v_pages": torch.zeros(shape, dtype=rt.compute_dtype,
                                           device=dev)}
        cap = cfg.window_size if kind == "local" and cfg.window_size else \
            pool.max_pages_per_seq * pool.page_size
        return _kind_cache(kind, cfg, batch, cap, rt, dev)

    table = torch.zeros((batch, pool.max_pages_per_seq), dtype=torch.int32,
                        device=device)
    caches = {"layers": [layer(k, d) for k, d in zip(cfg.layer_kinds(),
                                                     devs)],
              "page_table": table}
    _place_tables(caches, devs)
    return caches


def _place_tables(caches: dict, layer_devices) -> None:
    """Keep one copy of the page table on every device the layers use: set
    ``"page_tables"`` when there is more than one (a new device's copy is
    made from stage 0's table), drop it when there is one."""
    table = caches["page_table"]
    devs = list(dict.fromkeys([table.device, *layer_devices]))
    if len(devs) == 1:
        caches.pop("page_tables", None)
        return
    old = caches.get("page_tables", {})
    caches["page_tables"] = {d: old[d] if d in old else table.to(d)
                             for d in devs}


def page_tables(caches: dict) -> List[torch.Tensor]:
    """Every copy of the device page table (one a device the layers use)."""
    if "page_tables" in caches:
        return list(caches["page_tables"].values())
    return [caches["page_table"]]


def page_table_on(caches: dict, device=None) -> torch.Tensor:
    """The page table's copy on ``device`` (stage 0's when None)."""
    table = caches["page_table"]
    if device is None or table.device == device:
        return table
    return caches["page_tables"][device]


def set_page_table(caches: dict, table: np.ndarray) -> dict:
    """Copy the host page table (batch, max_pages) into every copy of the
    device table, in place."""
    host = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int32))
    for t in page_tables(caches):
        t.copy_(host)
    return caches


def place_caches(caches: dict, layer_devices) -> int:
    """Move engine caches in place so that layer ``i``'s pools, ring or
    state sit on ``layer_devices[i]``, one layer at a time, and keep a
    copy of the page table on each device the layers use (stage 0's table
    stays where it is).  Contents move with the tensors.  Returns the bytes
    moved."""
    moved = 0
    for i, dev in enumerate(layer_devices):
        layer = caches["layers"][i]
        if all(t.device == dev for t in layer.values()):
            continue
        moved += sum(t.numel() * t.element_size() for t in layer.values()
                     if t.device != dev)
        caches["layers"][i] = {name: t.to(dev) for name, t in layer.items()}
    _place_tables(caches, layer_devices)
    return moved


def reset_slot(caches: dict, slot: int) -> dict:
    """Clear a slot's per-row state when it is reassigned, in place: ring
    positions back to -1, and every leaf of a recurrent state back to its
    zero state: 0, except an sLSTM layer's normaliser ``n`` (the one 2-D
    ``n``), which starts at 1e-6.  Paged pools need no clearing (validity
    is governed by the sequence lengths).  This is what
    ``repro.serving.kv_cache.reset_slot`` means to do; the reference never
    reaches the recurrent layers (ROADMAP Queue 3)."""
    for layer in caches["layers"]:
        if "k_pages" in layer:
            continue
        if "pos" in layer:
            layer["pos"][slot] = -1
            continue
        for name, leaf in layer.items():
            leaf[slot] = 1e-6 if name == "n" and leaf.dim() == 2 else 0.0
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


def state_rows(caches: dict, start: int, size: int,
               layers: Optional[tuple] = None) -> List[torch.Tensor]:
    """Rows ``[start, start + size)`` of every recurrent-state leaf of the
    layers ``layers = (lo, hi)`` (every layer when None), as views: what a
    decode step over those rows changes that a second step at the same
    positions would step again.  Pools and rings are written by position
    (a second step writes the same slots), so they are not listed."""
    lo, hi = layers or (0, len(caches["layers"]))
    return [t[start:start + size] for layer in caches["layers"][lo:hi]
            if "k_pages" not in layer and "pos" not in layer
            for t in layer.values()]


def slot_view(caches: dict, start: int, size: int, device=None) -> dict:
    """A ``size``-row view of the batch starting at ``start``: the page
    table rows (of the table's copy on ``device``, stage 0's when None) and
    each ring's and recurrent state's rows are views (no copy), the shared
    pools pass through whole.  The model writes pools, rings and states in
    place, so nothing is merged back."""
    def rows(layer: dict) -> dict:
        if "k_pages" in layer:
            return layer
        return {name: t[start:start + size] for name, t in layer.items()}
    return {"layers": [rows(layer) for layer in caches["layers"]],
            "page_table": page_table_on(caches, device)[start:start + size]}


def slot_take(caches: dict, slot: torch.Tensor, layers: tuple,
              device=None) -> dict:
    """A one-row copy of the row a device tensor ``slot`` (1,) int64 names,
    for the layers ``layers = (lo, hi)``: each ring's and recurrent state's
    row gathered into a new tensor, the page table's row of its copy on
    ``device`` (stage 0's when None) likewise; the shared pools pass
    through whole, and the layers outside the range are None.  The
    counterpart of :func:`slot_view` for a slot the host does not name, so
    that one captured exact-prefill step serves every slot: the model
    writes the copy (and the pools in place), and :func:`slot_put` writes
    the copy back."""
    lo, hi = layers

    def rows(i: int, layer: dict):
        if not lo <= i < hi:
            return None
        if "k_pages" in layer:
            return layer
        return {name: t.index_select(0, slot) for name, t in layer.items()}
    return {"layers": [rows(i, layer)
                       for i, layer in enumerate(caches["layers"])],
            "page_table": page_table_on(caches, device).index_select(0, slot)}


def slot_put(caches: dict, slot: torch.Tensor, view: dict) -> None:
    """Write :func:`slot_take`'s copy back into row ``slot`` of each ring
    and recurrent state, in place (the pools were written in place)."""
    for layer, rows in zip(caches["layers"], view["layers"]):
        if rows is None or "k_pages" in layer:
            continue
        for name, t in layer.items():
            t.index_copy_(0, slot, rows[name])
