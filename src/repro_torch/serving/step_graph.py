"""Serving steps captured as CUDA graphs: the port's counterpart of the
JAX package's jitted decode, pipe and prefill steps
(``repro.serving.backend``'s ``LocalBackend._decode_jit`` and
``_chunk_jit``, ``PipelinedBackend._tick_jit`` and ``_pf_tick_jit``, and
``_prefill_jits``, one a bucketed prompt length).

An eager step issues thousands of launches from one host thread, and the
host takes longer to issue them than the card takes to run them.  A step
has fixed shapes for a given key, and its cache rows, pools and page
table sit at fixed addresses for the backend's lifetime (swaps,
page-table pushes and slot resets copy in place).  So a backend captures
each step once as a CUDA graph and replays it; the host only copies the
call's inputs into the step's static tensors and launches the graph.
The keys, by their first element (the key's kind):

- ``("local", mb, sampled)``: the local backend's decode tick;
  ``("stage", s, mb)`` and ``("drain", mb, sampled)``: a pipe stage's
  and the drained microbatch's decode work;
- ``("chunk", R, C, P)``: the local backend's prefill chunk of ``R`` rows
  of ``C`` tokens over ``P`` table columns (the engine fixes the shape,
  so one key a backend); ``("pf-stage", s, R, C, P)`` and ``("pf-drain",
  R, C, P)``: a pipe stage's and the drained chunk's prefill work;
- ``("exact", L, s)``: stage ``s`` of an exact prefill of a prompt padded
  to ``L`` tokens (``OfflineEngine._prefill_len``'s bucket); the slot and
  the last index are read from device tensors, so one graph serves every
  slot, and the last stage also runs the epilogue and the head;
- ``("fixed-decode", s, m)`` and ``("fixed-prefill", s, m, S)``: stage
  ``s`` of a fixed-batch pass over microbatch ``m`` (S-token prompts for
  a prefill), ``("fixed-embed", inputs)``, ``("fixed-prefill-head", S)``,
  ``("fixed-decode-head",)`` and ``("fixed-drain", m)``: the prefill's
  embedding, the whole-batch epilogue and head of a prefill and of a
  decode step, and a greedy round's drain of microbatch ``m``
  (``core.pipeline.FixedPasses``, the counterpart of the jitted passes);
- ``("train", batch shapes, accum_steps)``: a training step
  (``training.train_loop.train``, the counterpart of its
  ``jax.jit(step_fn, donate_argnums=(0, 1))``), captured at its second
  step, its first run eagerly.

:class:`StepGraphs` holds a backend's graphs, one a key:

- A step is a function of no arguments that reads the backend's static
  input tensors and writes its static output tensors (allocated outside
  any capture, by the backend).
- A key is captured at its first run, or at its second with ``defer``
  (the exact-prefill keys: a serve may meet a bucket once, and a capture
  costs about an eager run of host time, so a bucket seen once runs
  eagerly; its first run is the step called as it is, the call's result;
  and the training step, whose eager first step is step 1).  A key
  captured at its first run first runs once eagerly on the current
  stream, the engine's (the warm-up: it loads kernel libraries, sets
  their attributes, resolves the driver's entry points and fills the
  lazily built tables outside the capture), with the recurrent-state
  rows the step updates (``state``) copied aside before and back after
  it; pools and rings are written by position, so the replay writes the
  same slots again.  A deferred key's eager first run did all that
  already, and its rows are not copied: a CUDA capture runs nothing
  (``capture_runs_step`` is false; a stand-in whose capture runs the
  step sets it, and the rows are then copied aside and back around the
  capture too).  Then the step is captured on the card's capture stream
  with the paged kernel's workspace pinned, and replayed: from its
  capture on, every run of the key is a replay.  With ``release_cache``
  the card's cached free blocks are released first
  (``torch.cuda.empty_cache``): a capture cannot take blocks from the
  default pool, where a large eager first run, a training step's, left
  its activations' blocks.
- Launch counts stay what an eager serve counts.  The wrappers' counters
  (``.launches``) move while a step is captured; the graph keeps those
  counts and adds them at every replay, and the counters are put back
  after the capture.  A warm-up's launches belong to the capture, not to
  a call: they are booked in ``warmup_launches`` and put back too.  A
  deferred key's eager first run counts as the eager call it is.
- Every capture on a card runs on one stream made for it
  (``_capture_stream``), whose cuBLAS workspaces are made before the
  first capture: a workspace made inside a capture would pin a segment
  of that graph's pool for the process's life.
- All of a backend's graphs on a card share one memory pool
  (``torch.cuda.graph_pool_handle``).  That is safe in any replay order
  only because no graph's output lives in the pool: every tensor a step
  leaves behind is a static tensor written by a copy inside the graph
  (a prefill's logits are copied out of theirs before they are handed
  on), so what a graph takes from the pool is dead when its replay ends,
  and the next replay of any graph may reuse it.  A card's replays never
  overlap: they go to one stream, in the engine's order.
- A graph keeps the paged workspace tensors it was captured over
  (``kernels.paged_attention.reserve_workspace``), so a later growth of
  the card's workspace never frees a buffer a graph points at.  The
  flash and scan kernels encode their TMA maps on the host at launch, so
  a captured launch keeps the addresses it was captured with: what they
  read is made inside the step (in the graph's pool) or is a static
  tensor, never a tensor made outside the graph per call.
- The cyclic garbage collector is off while a step is recorded: a
  dropped backend's graphs freed by a collection during another capture
  would invalidate it.
- Off the card (a CPU device, the CPU stage of a mixed pipeline) the step
  is called as it is, every time: the routing rule.  A capture or replay
  that fails raises; nothing falls back to the eager step on the card.
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional

import torch

from repro_torch.kernels import chunk_attention as _chunk
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rglru_scan as _scan

# the kinds of the serving keys, decode and prefill (the fixed passes' and
# the training step's are in neither)
DECODE_KINDS = ("local", "stage", "drain")
PREFILL_KINDS = ("chunk", "pf-stage", "pf-drain", "exact")


def counted_kernels() -> Dict[str, Callable]:
    """Each kernel wrapper, by kernel; ``.launches`` is its count."""
    return {"paged_attention": _paged.paged_decode_attention,
            "flash_attention": _flash.flash_attention,
            "rglru_scan": _scan.rglru_scan,
            "chunk_attention": _chunk.paged_chunk_attention}


def _counts() -> Counter:
    return Counter({name: fn.launches
                    for name, fn in counted_kernels().items()})


def _set_counts(counts: Counter) -> None:
    for name, fn in counted_kernels().items():
        fn.launches = counts[name]


def _restore(rows: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    for t, s in zip(rows, saved):
        t.copy_(s)


def _on(device: torch.device):
    """The context of a capture or a replay on ``device``: the card made
    current (its current stream is the engine's); none off the card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _kind(key: Hashable):
    return key[0] if isinstance(key, tuple) else key


# one capture stream a card for the process.  cuBLAS keeps a workspace a
# (handle, stream) for the process's life, made at the stream's first
# GEMM: made inside a capture, it would sit in that graph's pool and keep
# the pool segment it was cut from (4 GiB of a gemma3-1b training step's)
# reserved after the graph is gone.  So the stream's first GEMMs run
# here, before any capture, and every capture uses the stream.
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """``device``'s capture stream, its cuBLAS and cuBLASLt workspaces
    made at its creation (a product and a product with a bias, float32
    and bf16)."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones((64, 64), dtype=dtype, device=device)
                torch.addmm(a[0], a, a)
                torch.mm(a, a)
        _CAPTURE_STREAMS[device] = stream
    return stream


@dataclass
class _Entry:
    graph: object                   # torch.cuda.CUDAGraph (or a test's)
    launches: Counter               # kernel launches captured, by kernel
    keep: tuple                     # the paged workspace it was captured over


class StepGraphs:
    """One backend's captured steps, one a key (see the module docstring).
    ``prepare(device)`` runs once a card before its first capture (the
    backend sizes the paged workspace there); ``release_cache`` empties
    the card's cache before each capture."""

    # whether ``_new_graph`` runs the step while it records (a CUDA
    # capture does not; the CPU tests' stand-in does)
    capture_runs_step = False

    def __init__(self, prepare: Optional[Callable] = None,
                 release_cache: bool = False):
        self._prepare = prepare
        self._release_cache = release_cache
        self._entries: Dict[Hashable, _Entry] = {}
        self._pools: Dict[torch.device, tuple] = {}
        self._prepared: set = set()
        self.captures: Counter = Counter()      # key -> captures made
        self.replays: Counter = Counter()       # key -> replays
        self.eager_runs: Counter = Counter()    # key -> deferred first runs
        self.replays_by_device: Counter = Counter()
        self.warmup_launches: Counter = Counter()
        self.capture_s = 0.0        # host seconds spent warming up and
                                    # capturing (a one-off, like a compile)
        self.capture_s_by_kind: Counter = Counter()
        self.instantiate_s = 0.0    # of which in capture_end (instantiation)

    def graphed(self, device: torch.device) -> bool:
        """Whether a step on ``device`` is captured and replayed (a card)
        or called as it is (the CPU)."""
        return device.type == "cuda"

    def entries(self) -> Dict[Hashable, tuple]:
        """Each captured key's ``(graph identity, captures made)``, for the
        strict auditor: a key must keep one graph for the whole serve."""
        return {key: (id(e.graph), self.captures[key])
                for key, e in self._entries.items()}

    def run(self, key: Hashable, device: torch.device, step: Callable,
            state: Optional[Callable] = None, defer: bool = False) -> None:
        """Run ``step`` for ``key`` on ``device``: replay the key's graph,
        capturing it first at its first run (at its second with
        ``defer``, the first calling ``step`` as it is), or call ``step``
        off the card.  ``state()`` lists the recurrent-state rows the step
        updates."""
        if not self.graphed(device):
            step()
            return
        entry = self._entries.get(key)
        if entry is None:
            if defer and not self.eager_runs[key]:
                with _on(device):
                    step()
                self.eager_runs[key] += 1
                return
            t0 = time.perf_counter()
            entry = self._entries[key] = self._capture(
                key, device, step, state, warm=not defer)
            dt = time.perf_counter() - t0
            self.capture_s += dt
            self.capture_s_by_kind[_kind(key)] += dt
        with _on(device):
            entry.graph.replay()
        for name, fn in counted_kernels().items():
            fn.launches += entry.launches[name]
        self.replays[key] += 1
        self.replays_by_device[str(device)] += 1

    def _new_graph(self, device: torch.device, step: Callable):
        """Capture ``step`` into a new graph on ``device``'s capture stream
        (``device`` is the current device), in the backend's pool."""
        stream = _capture_stream(device)
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
        stream.wait_stream(torch.cuda.current_stream(device))
        # repro-torch-audit: allow(retrace-jit) — memoised by key in run(): one capture a key for the backend's lifetime (the strict auditor pins each key's graph)
        graph = torch.cuda.CUDAGraph()
        # no collection while the step is recorded: one could destroy an
        # unreachable graph (a dropped backend's), and that call, made
        # during a capture, invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _paged.pinned(device), torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pools[device],
                                    capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    t0 = time.perf_counter()
                    graph.capture_end()
                    self.instantiate_s += time.perf_counter() - t0
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(device).wait_stream(stream)
        return graph

    def _capture(self, key: Hashable, device: torch.device, step: Callable,
                 state: Optional[Callable], warm: bool = True) -> _Entry:
        with _on(device):
            if self._prepare is not None and device not in self._prepared:
                self._prepare(device)
                self._prepared.add(device)
            rows: List[torch.Tensor] = state() if state is not None else []
            # copied aside only where a run would step them again: a
            # deferred key's capture runs nothing on a card
            saved = [t.clone() for t in rows] \
                if warm or self.capture_runs_step else []
            before = _counts()
            if warm:
                step()                      # the warm-up, eagerly
                _restore(rows, saved)
                self.warmup_launches.update(_counts() - before)
                _set_counts(before)
            if self._release_cache and device.type == "cuda":
                torch.cuda.empty_cache()
            graph = self._new_graph(device, step)
            if self.capture_runs_step:
                # a stand-in that runs the step while it records (the CPU
                # tests') must leave no trace either
                _restore(rows, saved)
            launches = _counts() - before
            _set_counts(before)
        self.captures[key] += 1
        return _Entry(graph, launches, _paged.workspace(device))

    def clear(self) -> None:
        """Drop every graph (a reshard's old backend).  Each card is
        synchronised first: a replay still running must not see its pool
        handed to other tensors."""
        for dev in self._pools:
            if dev.type != "cuda":
                continue
            # repro-torch-audit: allow(host-sync) — once a backend's life, when a reshard drops the drained pipe's graphs
            torch.cuda.synchronize(dev)
        self._entries.clear()
        self._pools.clear()
        self._prepared.clear()

    def stats(self) -> dict:
        """Captures, replays and deferred eager first runs, in total and by
        key kind (the key's first element), the capture seconds (of which
        instantiation), the warm-ups' launches, and the same split into
        the serving decode and prefill keys (the fixed passes' and the
        training step's kinds are in neither)."""
        def by_kind(counts: Counter) -> dict:
            kinds = Counter()
            for key, n in counts.items():
                kinds[_kind(key)] += n
            return dict(kinds)

        def part(kinds: dict, prefill: bool) -> int:
            return sum(n for k, n in kinds.items()
                       if k in (PREFILL_KINDS if prefill else DECODE_KINDS))
        replays, captures = by_kind(self.replays), by_kind(self.captures)
        return {"captures": sum(self.captures.values()),
                "keys": len(self.captures),
                "capture_s": self.capture_s,
                "instantiate_s": self.instantiate_s,
                "replays": sum(self.replays.values()),
                "replays_by_kind": replays,
                "captures_by_kind": captures,
                "eager_by_kind": by_kind(self.eager_runs),
                "capture_s_by_kind": dict(self.capture_s_by_kind),
                "decode_captures": part(captures, False),
                "decode_replays": part(replays, False),
                "prefill_captures": part(captures, True),
                "prefill_replays": part(replays, True),
                "replays_by_device": dict(self.replays_by_device),
                "warmup_launches": dict(self.warmup_launches)}
