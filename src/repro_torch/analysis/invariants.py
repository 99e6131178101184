"""Runtime invariant auditor for the port's serving engine (strict mode;
own copy of ``repro.analysis.invariants``).

Enabled via ``EngineConfig(strict=True)``, ``OfflineEngine(...,
strict=True)``, or the ``REPRO_STRICT=1`` environment variable (the test
suite defaults it on).  The engine calls the three hooks after every
admission (``submit``), tick (``step``), and elastic rebuild
(``reshard``); each hook re-checks the full invariant set and raises
:class:`InvariantViolation` at the first breach — the point of strict
mode is to fail at the tick that corrupted state, not at the assert that
happened to read it later.

Checked invariants (the reference's, read from the port's own state):

* **page accounting** — the allocator's free lists plus the owned pages
  exactly partition the non-scratch page universe (no leak, no
  double-grant, scratch page 0 never owned); every page's refcount
  equals its ownership multiplicity (slots listing it + prefix-cache
  retains), shared pages are local-only (global pools parity-swap),
  owned pages belong only to occupied slots or the prefix cache, and
  the engine's host page table matches the allocator's view row for
  row.  The reference's shared-parity global pools (ROADMAP Queue 3)
  are accepted exactly as the JAX auditor accepts them;
* **Status lifecycle** — per-sequence transitions follow the FSM
  QUEUED → PREFILLING → DECODING → FINISHED, with the single legal
  back-edge PREFILLING → QUEUED (admission rollback on page
  exhaustion); container placement matches status (queue holds QUEUED,
  slots hold PREFILLING/DECODING at slot == seq.slot, finished holds
  FINISHED);
* **transport books** — ``VirtualClock`` time and the wire-byte /
  send / stall books are monotone non-decreasing across every
  ``Transport`` crossing *including reshard* (``for_stages`` must carry
  the books — a reset-to-zero after a rebuild is a conservation bug),
  and bytes only move with a send;
* **offload double-buffer parity** — each offloader (the local
  backend's ``offloader``, the pipelined backend's ``stage_offloaders``
  and ``epilogue_offloader``) binds global pool parity ``p`` only to
  microbatches with ``mb % 2 == p``, its host store never keys a
  currently-resident microbatch, and its swap counters are monotone
  non-decreasing for the offloader's lifetime (reset only when reshard
  rebuilds the backend with fresh offloaders);
* **captured decode steps** — the counterpart of the reference's jit
  cache-size probes (``jit_entries``: each tick jit compiled once for the
  whole serve).  A backend captures each decode step as a CUDA graph
  once a key (``serving.step_graph``) and exposes them through
  ``graph_entries()`` (key -> (graph identity, captures)); the auditor
  pins each key's graph at its first sighting and fails if a key was
  captured twice or its graph changed — a second capture mid-serve costs
  a warm-up and a capture, and would leave the old graph's replays
  pointing at whatever it was captured over.  A reshard builds a new
  backend, which captures anew: the pins start over.  Off the card
  nothing is captured and nothing is checked;
* **kernel libraries** — a model call launches the same hand-written
  kernels whatever the shapes, so a shape leak or a weak-type flip cannot
  make a second compiled kernel, and a non-hashable static argument has
  nothing to defeat.  What *can* happen mid-serve is a kernel library
  built or loaded again
  (``repro_torch.kernels.build``): a different source hash or a second
  ``ctypes`` load would stall the serve for an ``nvcc`` run and leave two
  copies of a kernel's device state.  The backend exposes the loaded
  libraries through ``kernel_libraries()`` (one library a name); the
  auditor pins each name's path and handle at its first sighting and
  fails if either changes, across reshard too.  Off the card nothing is
  loaded and nothing is checked.

The audit is pure host-side bookkeeping over state the engine already
holds on host (numpy page table, python free lists, transport counters,
offloader dicts) — it never reads a pool tensor or any other CUDA tensor,
so strict mode adds no device sync; cost is O(pages + slots) per step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["EngineAuditor", "InvariantViolation", "library_identity"]


class InvariantViolation(AssertionError):
    """A strict-mode engine invariant was broken."""


def library_identity(lib) -> Optional[Tuple[str, int]]:
    """``(path, handle)`` of a loaded ``ctypes`` kernel library, or
    ``None`` when ``lib`` is not one (nothing to pin: ``None`` means
    "cannot check", never "violation")."""
    name = getattr(lib, "_name", None)
    handle = getattr(lib, "_handle", None)
    if not isinstance(name, str) or not isinstance(handle, int):
        return None
    return name, handle


def _fail(where: str, msg: str) -> None:
    raise InvariantViolation(f"[{where}] {msg}")


class EngineAuditor:
    """Attached to one engine; re-entrant across reshard (the engine
    object survives a rebuild, only its backend is replaced)."""

    def __init__(self, engine) -> None:
        self._engine = engine
        # id(seq) -> (status, request_id); seqs are retained by the
        # engine's queue/slots/finished lists, so ids stay stable for
        # the sequences we still track
        self._last_status: Dict[int, Tuple[object, int]] = {}
        self._books: Dict[str, float] = {}
        self._off_books: Dict[str, Tuple[int, int]] = {}
        # kernel library name -> (path, handle) at its first sighting
        self._libraries: Dict[str, Tuple[str, int]] = {}
        # captured step key (decode and prefill) -> graph identity, for
        # one backend
        self._graphs: Dict[object, int] = {}
        self._graph_backend: Optional[int] = None
        self.checks = 0

    # ---- hooks the engine calls ------------------------------------

    def after_submit(self) -> None:
        self._audit("submit", resharded=False)

    def after_step(self) -> None:
        self._audit("step", resharded=False)

    def after_reshard(self) -> None:
        self._audit("reshard", resharded=True)

    # ---- audit passes ----------------------------------------------

    def _audit(self, where: str, *, resharded: bool) -> None:
        self.checks += 1
        self._audit_pages(where)
        self._audit_fsm(where)
        self._audit_transport(where, resharded=resharded)
        self._audit_offload(where, resharded=resharded)
        self._audit_graphs(where, resharded=resharded)
        self._audit_kernels(where)

    def _audit_pages(self, where: str) -> None:
        eng = self._engine
        alloc, pool = eng.alloc, eng.pool
        universe = set(range(1, pool.n_local_pages))
        universe |= set(pool.global_range(0)) | set(pool.global_range(1))

        free: List[int] = list(alloc._free_local)
        for gp in alloc._free_global.values():
            free.extend(gp)
        # multiplicity of ownership: how many slots list each page, plus
        # one per prefix-cache retain — must equal the allocator refcount
        owner_count: Dict[int, int] = {}
        for slot, pages in alloc._seq_pages.items():
            if len(pages) != len(set(pages)):
                _fail(where, f"page audit: slot {slot} lists a page "
                             f"twice (pages={pages})")
            for p in pages:
                owner_count[p] = owner_count.get(p, 0) + 1
        cache = getattr(eng, "prefix_cache", None)
        if cache is not None:
            retained = cache.pages_retained()
            if len(retained) != len(set(retained)):
                _fail(where, "page audit: prefix cache retains a page "
                             f"under two entries ({sorted(retained)})")
            for p in retained:
                owner_count[p] = owner_count.get(p, 0) + 1
        owned = set(owner_count)

        if len(free) != len(set(free)):
            _fail(where, "page audit: duplicate page in the free lists "
                         f"(free={sorted(free)})")
        overlap = set(free) & owned
        if overlap:
            _fail(where, f"page audit: pages {sorted(overlap)} are both "
                         "free and owned")
        if 0 in free or 0 in owned:
            _fail(where, "page audit: scratch page 0 entered the "
                         "allocator (it must stay reserved)")
        seen = set(free) | owned
        if seen != universe:
            leaked = sorted(universe - seen)
            conjured = sorted(seen - universe)
            _fail(where, "page audit: free+owned does not partition the "
                         f"page universe (leaked={leaked}, "
                         f"out-of-range={conjured})")

        # refcounts are the ownership multiplicity, exactly
        refs = dict(getattr(alloc, "_refs", {}))
        if refs != owner_count:
            diff = {p: (owner_count.get(p, 0), refs.get(p, 0))
                    for p in set(refs) | set(owner_count)
                    if refs.get(p, 0) != owner_count.get(p, 0)}
            _fail(where, "page audit: allocator refcounts disagree with "
                         f"ownership (page -> (owners, refcount)): {diff}")
        # sharing is legal only for local pages — global-pool content is
        # parity-swapped per microbatch by the offloader
        shared_global = sorted(p for p, n in owner_count.items()
                               if n > 1 and p >= pool.n_local_pages)
        if shared_global:
            _fail(where, f"page audit: global pages {shared_global} are "
                         "shared — offload parity swaps would clobber "
                         "one owner's view")

        occupied = {slot for slot, seq in enumerate(eng.slots)
                    if seq is not None}
        stray = set(alloc._seq_pages) - occupied
        if stray:
            _fail(where, f"page audit: slots {sorted(stray)} own pages "
                         "but hold no sequence (release missed on "
                         "finish/evict)")

        # published table vs allocator truth: a slot's row is either the
        # allocator's view or still all-zero (admitted this step, first
        # chunk not yet published) — anything else serves stale pages
        for slot in sorted(alloc._seq_pages):
            row = np.asarray(eng.table[slot])
            want = alloc.table_row(slot)
            if row.any() and not np.array_equal(row, want):
                _fail(where, f"page audit: published table row for slot "
                             f"{slot} is {row.tolist()} but the "
                             f"allocator owns {want.tolist()}")
        for slot in sorted(occupied - set(alloc._seq_pages)):
            # a slot without pages must be parked on scratch
            if np.asarray(eng.table[slot]).any():
                _fail(where, f"page audit: slot {slot} owns no pages "
                             "but its table row is non-zero")

    def _audit_fsm(self, where: str) -> None:
        from repro_torch.serving.request import Status
        eng = self._engine
        rank = {Status.QUEUED: 0, Status.PREFILLING: 1,
                Status.DECODING: 2, Status.FINISHED: 3}

        def check(seq, container: str, allowed, slot=None):
            rid = seq.request.request_id
            if seq.status not in allowed:
                _fail(where, f"fsm: request {rid} has status "
                             f"{seq.status.name} inside {container} "
                             f"(allowed: "
                             f"{'/'.join(s.name for s in allowed)})")
            if slot is not None and seq.slot != slot:
                _fail(where, f"fsm: request {rid} sits in slot {slot} "
                             f"but records seq.slot={seq.slot}")
            prev = self._last_status.get(id(seq))
            if prev is not None:
                old, old_rid = prev
                backward = rank[seq.status] < rank[old]
                requeue = (old is Status.PREFILLING
                           and seq.status is Status.QUEUED)
                if old_rid == rid and backward and not requeue:
                    _fail(where, f"fsm: request {rid} moved backward "
                                 f"{old.name} -> {seq.status.name} "
                                 "(only PREFILLING -> QUEUED may "
                                 "rewind, on admission rollback)")
            return id(seq), (seq.status, rid)

        fresh: Dict[int, Tuple[object, int]] = {}
        for seq in eng.queue:
            k, v = check(seq, "queue", (Status.QUEUED,))
            fresh[k] = v
        for slot, seq in enumerate(eng.slots):
            if seq is None:
                continue
            k, v = check(seq, "slots",
                         (Status.PREFILLING, Status.DECODING), slot=slot)
            fresh[k] = v
        for seq in eng.finished:
            k, v = check(seq, "finished", (Status.FINISHED,))
            fresh[k] = v
        # forget sequences no longer held by the engine so recycled
        # object ids can't alias into stale entries
        self._last_status = fresh

    def _audit_transport(self, where: str, *, resharded: bool) -> None:
        transport = getattr(self._engine.backend, "transport", None)
        if transport is None:
            return
        try:
            stats = transport.stats() or {}
        except Exception:
            return
        monotone = ("virtual_time_s", "wire_bytes", "link_sends",
                    "link_stall_s", "raw_bytes")
        prev = self._books
        for key in monotone:
            if key not in stats:
                continue
            now = float(stats[key])
            if now < 0:
                _fail(where, f"transport: {key} is negative ({now})")
            before = prev.get(key)
            if before is not None and now < before - 1e-9:
                carry = (" — for_stages() dropped the books across "
                         "reshard" if resharded else "")
                _fail(where, f"transport: {key} went backward "
                             f"{before} -> {now}{carry}")
        d_wire = float(stats.get("wire_bytes", 0)) - prev.get(
            "wire_bytes", 0.0)
        d_sends = float(stats.get("link_sends", 0)) - prev.get(
            "link_sends", 0.0)
        if d_wire > 0 and d_sends <= 0:
            _fail(where, f"transport: {d_wire:.0f} wire bytes booked "
                         "with no send recorded (byte conservation)")
        clock = getattr(transport, "clock", None)
        if clock is not None and float(getattr(clock, "now", 0.0)) < 0:
            _fail(where, "transport: virtual clock is negative")
        audit = getattr(transport, "audit", None)
        if audit is not None:
            try:
                audit()
            except AssertionError as e:
                _fail(where, f"transport: {e}")
        self._books = {k: float(stats[k]) for k in monotone
                       if k in stats}

    def _audit_offload(self, where: str, *, resharded: bool) -> None:
        backend = self._engine.backend
        offs: List[Tuple[str, object]] = []
        local = getattr(backend, "offloader", None)
        if local is not None:
            offs.append(("offloader", local))
        for i, o in enumerate(getattr(backend, "stage_offloaders", ())
                              or ()):
            offs.append((f"stage_offloaders[{i}]", o))
        epi = getattr(backend, "epilogue_offloader", None)
        if epi is not None:
            offs.append(("epilogue_offloader", epi))
        if resharded:
            # reshard rebuilds the backend with fresh offloaders — their
            # counters legitimately restart from zero
            self._off_books = {}
        for name, off in offs:
            resident = getattr(off, "resident", None)
            if not isinstance(resident, dict):
                continue
            held = set()
            for parity, mb in resident.items():
                if mb is None:
                    continue
                held.add(mb)
                if mb % 2 != parity:
                    _fail(where, f"offload: {name} binds microbatch {mb} "
                                 f"to global pool parity {parity} — the "
                                 "double-buffer schedule requires "
                                 "mb % 2 == parity")
            stale = held & set(getattr(off, "_host", {}))
            if stale:
                _fail(where, f"offload: {name} keeps host-store copies "
                             f"for resident microbatch(es) {sorted(stale)}"
                             " — those bytes go stale the moment the "
                             "pool mutates (swap-in must pop)")
            swaps = int(getattr(off, "swap_count", 0))
            moved = int(getattr(off, "bytes_swapped", 0))
            if swaps < 0 or moved < 0:
                _fail(where, f"offload: {name} swap counters are "
                             f"negative (swaps={swaps}, bytes={moved})")
            prev = self._off_books.get(name)
            if prev is not None and (swaps < prev[0] or moved < prev[1]):
                _fail(where, f"offload: {name} counters went backward "
                             f"(swaps {prev[0]} -> {swaps}, bytes "
                             f"{prev[1]} -> {moved})")
            self._off_books[name] = (swaps, moved)

    def _audit_graphs(self, where: str, *, resharded: bool) -> None:
        backend = self._engine.backend
        entries = getattr(backend, "graph_entries", None)
        if entries is None:
            return
        if resharded or self._graph_backend != id(backend):
            self._graphs = {}           # a new backend captures anew
            self._graph_backend = id(backend)
        for key, (ident, captures) in entries().items():
            if captures > 1:
                _fail(where, f"graphs: step {key!r} was captured "
                             f"{captures} times — one key must be "
                             "captured exactly once for the backend's "
                             "life")
            first = self._graphs.setdefault(key, ident)
            if ident != first:
                _fail(where, f"graphs: step {key!r} holds another "
                             "graph than at its first sighting — it was "
                             "captured again mid-serve")

    def _audit_kernels(self, where: str) -> None:
        entries = getattr(self._engine.backend, "kernel_libraries", None)
        if entries is None:
            return
        for name, lib in entries().items():
            ident = library_identity(lib)
            if ident is None:
                continue
            first = self._libraries.setdefault(name, ident)
            if ident != first:
                _fail(where, f"kernels: library {name!r} was built or "
                             f"loaded again mid-serve ({first[0]} -> "
                             f"{ident[0]}, handle {first[1]:#x} -> "
                             f"{ident[1]:#x}); one library a kernel must "
                             "serve the whole run")
