"""Execution backends for the offline serving engine (counterpart of
``repro.serving.backend``).

The engine owns the bookkeeping (queue, slots, page allocator, host page
table, positions); a backend owns the device caches and the compute:

  ``prefill_step(chunk)`` — advance the prefill plane one tick, optionally
        injecting a :class:`PrefillChunk` (a fixed-shape batch of
        prompt-token rows with their own page-table rows).  The local
        backend returns the chunk's :class:`PrefillResult` at once; the
        pipelined one routes it stage to stage and returns it ``N_S − 1``
        ticks later.  ``prefill_can_accept`` / ``prefill_pending`` expose
        the pipe's state;
  ``prefill(tokens, slot, last_index)`` — the exact-length path: run one
        whole (padded) prompt into ``slot`` through the whole model and
        return its last-position logits;
  ``reset_slot(slot)`` — clear a reassigned slot's ring positions and
        recurrent states;
  ``decode(mb, tokens, cur_pos, samp)`` — advance microbatch ``mb`` one
        token tick and return zero or more :class:`DecodeResult`; a result
        may be for an *earlier* microbatch (a pipe drains with latency),
        so the engine applies results by the microbatch they carry, and
        ``busy_microbatches`` / ``pending`` say which are in flight;
  ``set_page_table`` — push the engine's host table to the device.

Two implementations:

``LocalBackend``
    The single-device path: one model call per prefill chunk and one per
    microbatch decode tick, over an ``mb_size`` row view of the caches.

``PipelinedBackend``
    DeServe's §4.3 circular schedule as a persistent stepper over the
    ``N_S``-stage tick functions of :mod:`repro_torch.core.pipeline`.  Each
    engine tick injects one microbatch at stage 0 and advances every
    in-flight one a stage; the microbatch leaving the last stage drains
    through the epilogue and the sampler ``N_S − 1`` ticks after its
    injection.  Every stage crossing travels a transport
    (:mod:`repro_torch.distributed.transport`): zero-cost in process, or a
    simulated link on a virtual clock.  The stages run in turn, in one
    process, on the device's current stream.

With offload (DeServe §4.2) a backend makes a microbatch's global pool
resident before every model call that may touch it: each residency
microbatch of a prefill chunk, an exact prefill into a slot that holds
global pages, and every decode tick.  The pipelined backend keeps one
:class:`repro_torch.core.offload.DoubleBufferOffloader` a stage, over that
stage's layers, and one for the epilogue when it holds paged layers.  Swap
copies go on the offloaders' copy streams; every model call, attention
kernels included, stays on the compute stream.

PyTorch runs eagerly, so ``_chunk_fn`` / ``_prefill_fn`` / ``_decode_fn``
are plain methods where the JAX package jits, and the JAX pipelined
backend's sharding-layout machinery (``_commit``, ``_probe_layout``,
``_cache_shardings``), which keeps its jit caches steady, has nothing to
do here.  Fault plans, the offload-state export for reshard, the stage
times for straggler mitigation and the flight recorder come with the
resilience and tracing slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import pipeline as PL
from repro_torch.core.offload import DoubleBufferOffloader
from repro_torch.distributed.transport import (CompressedTransport,
                                               InProcessTransport,
                                               make_transport)
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.sampler import (RowSampling, greedy, gumbel_noise,
                                         sample_batched, token_logprobs)


@dataclass
class DecodeResult:
    """One drained microbatch tick: ``tokens[i]`` is the next token for
    slot ``mb * mb_size + i`` (the engine decides which rows are live)."""
    mb: int
    tokens: np.ndarray                  # (mb_size,) int32
    logprobs: np.ndarray                # (mb_size,) f32, raw-logits logprob


@dataclass
class PrefillChunk:
    """One per-tick prefill work unit: up to R rows of C prompt tokens,
    shapes fixed by the engine (``prefill_rows`` x ``prefill_chunk``);
    padded rows carry ``n_valid == 0``."""
    tokens: np.ndarray                  # (R, C) int32
    offsets: np.ndarray                 # (R,) int32 tokens already prefilled
    n_valid: np.ndarray                 # (R,) int32 real tokens this chunk
    lasts: np.ndarray                   # (R,) int32 within-chunk index of the
                                        # final prompt token (-1: not final)
    tables: np.ndarray                  # (R, max_pages) int32 table rows
    seqs: list                          # engine-side SequenceState refs
    residency_mbs: tuple = ()           # microbatch ids (at most one per
                                        # global-pool parity) whose global
                                        # pool the chunk's rows write


@dataclass
class PrefillResult:
    """A finished prefill chunk: ``logits[i]`` are row ``i``'s
    last-position logits, meaningful only where ``chunk.lasts[i] >= 0``.
    They stay on the device (the engine samples first tokens there)."""
    chunk: PrefillChunk
    logits: torch.Tensor                # (R, V) float32, on the device


def stage_devices(mesh, n_stages: int, device) -> List[torch.device]:
    """The device of each pipeline stage.  ``mesh`` is ``None`` (every stage
    on ``device``) or a list of ``n_stages`` torch devices; one that names
    two or more distinct devices asks for stages on several GPUs, which the
    port does not run yet (ROADMAP Queue 1, "stages on several GPUs")."""
    device = torch.device(device)
    if mesh is None:
        return [device] * n_stages
    devs = [torch.device(d) for d in mesh]

    def key(d):
        return (d.type, d.index or 0)
    if len({key(d) for d in devs}) > 1:
        raise NotImplementedError(
            f"mesh {[str(d) for d in devs]} puts pipeline stages on "
            "several devices, which is not ported yet: it comes with the "
            "ROADMAP item 'stages on several GPUs' (every stage runs on "
            "one device, in one process)")
    if len(devs) != n_stages:
        raise ValueError(f"mesh has {len(devs)} device(s) for {n_stages} "
                         "stage(s): one device a stage")
    if key(devs[0]) != key(device):
        raise ValueError(f"mesh puts the stages on {devs[0]}, but the "
                         f"engine runs on {device}")
    return [device] * n_stages


class _SlotCacheBackend:
    """Shared plumbing over engine-format paged caches: the device caches,
    page-table pushes, slot resets and the exact-length prefill; the
    subclasses tick the decode and prefill planes."""

    name = "abstract"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device):
        self.cfg = cfg
        self.params = params
        self.rt = rt
        self.mb_size = mb_size
        self.num_microbatches = num_microbatches
        self.batch = mb_size * num_microbatches
        self.pool = pool
        self.device = device
        self.caches = kvc.build_paged_caches(cfg, self.batch, pool, rt, device)
        self.noise_gen = torch.Generator(device=device)
        self.decode_ticks = 0           # decode-plane ticks that ran

    def set_page_table(self, table: np.ndarray) -> None:
        self.caches = kvc.set_page_table(self.caches, table)

    def reset_slot(self, slot: int) -> None:
        """Clear a reassigned slot's per-row state (ring positions,
        recurrent states), in place."""
        self.caches = kvc.reset_slot(self.caches, slot)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the pipe's state (a local backend has nothing in flight) ----------

    def busy_microbatches(self) -> set:
        """Microbatches with a tick in flight: admission must not touch
        their slots or cache rows."""
        return set()

    def pending(self) -> bool:
        """True while decode ticks are in flight (the engine keeps
        draining)."""
        return False

    def prefill_can_accept(self) -> bool:
        """True when a new prefill chunk may be injected this tick."""
        return True

    def prefill_pending(self) -> bool:
        """True while prefill chunks are in flight."""
        return False

    def transport_stats(self) -> Dict:
        """The inter-stage transport's books (virtual clock, wire bytes,
        link stalls); empty where there are no stages or no books."""
        return {}

    # -- exact-length prefill ------------------------------------------------

    def _prefill_residency(self, mb: int) -> None:
        """Make ``mb``'s global pools resident before a prefill writes
        prompt KV into them (without this the next swap would clobber it)."""

    def prefill(self, tokens: np.ndarray, slot: int, last_index: int,
                has_global_pages: bool = True) -> torch.Tensor:
        """Prefill one whole prompt, right-padded to ``len(tokens)``, into
        ``slot`` through the whole model; returns its logits (V,) at
        ``last_index``, on the device."""
        toks = self._tensor(tokens[None])
        if has_global_pages:
            self._prefill_residency(slot // self.mb_size)
        logits = self._prefill_fn(self.params, self.caches, toks, slot,
                                  last_index, cfg=self.cfg, rt=self.rt)
        # as prefill_step: the prefill phase's clock measures the card
        self._sync()
        return logits

    @staticmethod
    def _prefill_fn(params, caches, tokens, slot, last_idx, *, cfg, rt):
        """One sequence into the batch-wide caches at ``slot``: a one-row
        view of the rings, the recurrent states and the page table stands
        in for the JAX package's slot_view / slot_merge (pools, rings and
        states are written in place through it).  Ring positions past the
        true last index are cleaned back to -1 afterwards."""
        view = kvc.slot_view(caches, slot, 1)
        last = torch.full((1,), last_idx, dtype=torch.int32,
                          device=tokens.device)
        logits, _ = model_lib.prefill(params, tokens, cfg, rt, 0,
                                      caches=view, last_index=last)
        for layer in view["layers"]:
            if "pos" in layer:
                layer["pos"].masked_fill_(layer["pos"] > last_idx, -1)
        return logits[0]


class LocalBackend(_SlotCacheBackend):
    """The single-device path: one model call per prefill chunk and one per
    microbatch decode tick, over an ``mb_size`` row view of the caches."""

    name = "local"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, offloader=None):
        super().__init__(cfg, params, rt, mb_size=mb_size,
                         num_microbatches=num_microbatches, pool=pool,
                         device=device)
        self.offloader = offloader

    def _residency(self, mb: int) -> None:
        """Make ``mb``'s global-pool parity resident before the model
        writes or reads it (without this a prefill could write prompt KV
        into another microbatch's content, which the next swap would
        clobber).  Callers copy their host inputs to the card first: a
        blocking host-to-device copy synchronises the compute stream, which
        after this call waits on the swap, so a copy made later would hold
        the host for the whole swap instead of letting it issue the model's
        launches meanwhile."""
        if self.offloader is not None:
            self.caches = self.offloader.ensure_resident(self.caches, mb)

    _prefill_residency = _residency

    @property
    def swap_count(self) -> int:
        return self.offloader.swap_count if self.offloader else 0

    # -- chunked prefill ---------------------------------------------------

    def prefill_step(self, chunk: Optional[PrefillChunk]
                     ) -> List[PrefillResult]:
        if chunk is None:
            return []
        inputs = [self._tensor(a) for a in (chunk.tokens, chunk.offsets,
                                            chunk.n_valid, chunk.lasts,
                                            chunk.tables)]
        for mb in chunk.residency_mbs:
            self._residency(mb)
        logits = self._chunk_fn(self.params, self.caches, *inputs,
                                cfg=self.cfg, rt=self.rt)
        # the chunk's work ends inside the engine's prefill phase, so its
        # prefill/decode time split measures the card, not the queue
        self._sync()
        return [PrefillResult(chunk=chunk, logits=logits)]

    @staticmethod
    def _chunk_fn(params, caches, tokens, offsets, n_valid, lasts, tables,
                  *, cfg, rt):
        """One prefill chunk: the model sees the chunk's own table rows
        (the device-wide table keeps prefilling slots parked on the scratch
        page until activation); pools are written in place."""
        view = {"layers": caches["layers"], "page_table": tables}
        logits, _ = model_lib.prefill_chunk(params, tokens, view, offsets,
                                            n_valid, lasts, cfg, rt)
        return logits

    # -- decode --------------------------------------------------------------

    def decode(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
               samp: RowSampling, active: bool = True) -> List[DecodeResult]:
        if not active:
            return []
        dev = self.device
        sampled = samp.any_sampled
        noise = gumbel_noise(samp, self.cfg.vocab_size, dev, self.noise_gen) \
            if sampled else None
        inputs = [self._tensor(a) for a in (tokens, cur_pos, samp.temp,
                                            samp.top_k, samp.top_p)]
        self._residency(mb)
        toks, lps = self._decode_fn(
            self.params, self.caches, inputs[0], inputs[1],
            mb * self.mb_size, noise, *inputs[2:], cfg=self.cfg, rt=self.rt,
            mb_size=self.mb_size, sampled=sampled)
        self.decode_ticks += 1
        # the tick's one device-to-host transfer: the engine books the
        # microbatch's tokens on the host
        out = torch.stack([toks.float(), lps]).cpu().numpy()
        return [DecodeResult(mb=mb, tokens=out[0].astype(np.int32),
                             logprobs=out[1])]

    @staticmethod
    def _decode_fn(params, caches, tokens, cur_pos, row0, noise, temp, top_k,
                   top_p, *, cfg, rt, mb_size, sampled):
        """One decode tick over an ``mb_size`` row view of the caches; rows
        outside the microbatch are untouched.  The view aliases the table,
        ring and recurrent-state rows, and pools, rings and states are
        written in place, so there is nothing to merge back.  ``sampled``
        (decided on the host) skips the truncation pass when every row is
        greedy."""
        view = kvc.slot_view(caches, row0, mb_size)
        logits, _ = model_lib.decode_step(params, tokens, view, cur_pos, cfg,
                                          rt)
        if sampled:
            toks = sample_batched(logits, noise, temp, top_k, top_p)
        else:
            toks = greedy(logits)
        return toks, token_logprobs(logits, toks)


class PipelinedBackend(_SlotCacheBackend):
    """DeServe's §4.3 circular schedule as a persistent stepper.

    Two shift registers hold what sits at each stage: ``_entries`` for the
    decode plane (``(mb, positions, RowSampling)`` captured at injection)
    and ``_pf_entries`` for the prefill plane (:class:`PrefillChunk`), with
    ``act`` / ``_pf_act`` the activations waiting at each stage's input.
    ``schedule="round_flush"`` reproduces the vLLM-PP baseline: the pipe is
    drained every token round (when the microbatch counter wraps), with
    the same ticks, so outputs are unchanged and only the virtual clock
    pays the fill and drain.  ``wire_dtype="int8"`` passes each stage's
    output on as its per-row int8 round trip and books the packed payload
    (a ``CompressedTransport`` wrap)."""

    name = "pipelined"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, n_stages: int = 2,
                 offload: bool = False, offload_async: bool = True,
                 mesh=None, transport=None, schedule: str = "circular",
                 wire_dtype: str = "fp32"):
        if wire_dtype not in PL.WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be 'fp32'|'int8', got "
                             f"{wire_dtype!r} (top-k has no codec in the "
                             "ticks — it stays wire-byte accounting only)")
        if num_microbatches < n_stages:
            raise ValueError(
                f"continuous batching over a {n_stages}-stage pipe needs "
                f"N_B >= N_S (got N_B={num_microbatches}); see §4.3 — a "
                "microbatch must drain before its next injection")
        if schedule not in ("circular", "round_flush"):
            raise ValueError(f"schedule must be 'circular'|'round_flush', "
                             f"got {schedule!r}")
        self.stage_devices = stage_devices(mesh, n_stages, device)
        super().__init__(cfg, params, rt, mb_size=mb_size,
                         num_microbatches=num_microbatches, pool=pool,
                         device=device)
        self.n_stages = n_stages
        self.wire_dtype = wire_dtype
        self.schedule = schedule
        self.ranges = PL.stage_ranges(cfg, n_stages)  # stages, epilogue
        self.act: list = [None] * n_stages
        self._entries: List[Optional[tuple]] = [None] * n_stages
        self._pf_act: list = [None] * n_stages
        self._pf_entries: List[Optional[PrefillChunk]] = [None] * n_stages
        self.decode_stage_runs = 0      # occupied stages summed over the
                                        # decode ticks (a stage run is one
                                        # pass over the stage's layers)
        self.epilogue_runs = 0          # decode ticks that drained
        self._last_inject_mb = -1       # round boundary detector
        self._ret_ready: Dict[int, float] = {}  # mb -> virtual time its
                                                # drained return payload
                                                # lands at the injector
        self._dtype_bytes = torch.empty((), dtype=rt.compute_dtype
                                        ).element_size()

        # inter-stage links: every entry crossing a stage boundary, decode
        # microbatches and prefill chunks, travels the transport; the call
        # sites pass RAW activation bytes, so a real int8 wire forces the
        # matching CompressedTransport wrap (or retunes an existing one)
        self.transport = make_transport(transport, n_stages)
        if wire_dtype == "int8" and \
                not isinstance(self.transport, InProcessTransport):
            if isinstance(self.transport, CompressedTransport):
                if self.transport.method != "int8":
                    raise ValueError(
                        f"wire_dtype='int8' but the transport accounts "
                        f"'{self.transport.method}' — use one codec for "
                        "both the wire and the books")
                self.transport.elem_bytes = self._dtype_bytes
                self.transport.row_elems = cfg.d_model
                self.transport._wire_cache.clear()
            else:
                self.transport = CompressedTransport(
                    self.transport, method="int8",
                    elem_bytes=self._dtype_bytes,
                    row_elems=cfg.d_model).bind(n_stages)

        # §4.2 offloading, per stage: stage s double-buffers its own layers'
        # slice of the global pools; the epilogue is one more unit, keyed
        # to the draining microbatch, when it holds paged layers
        self.stage_offloaders: List[DoubleBufferOffloader] = []
        self.epilogue_offloader: Optional[DoubleBufferOffloader] = None
        if offload and pool.n_global_pages:
            self.stage_offloaders = [
                DoubleBufferOffloader(pool, num_microbatches,
                                      async_swap=offload_async)
                for _ in range(n_stages)]
            if any("k_pages" in c for c in self._epi_view()["layers"]):
                self.epilogue_offloader = DoubleBufferOffloader(
                    pool, num_microbatches, async_swap=offload_async)

    # -- per-stage offload residency ---------------------------------------

    def _stage_view(self, s: int) -> dict:
        lo, hi = self.ranges[s]
        return {"layers": self.caches["layers"][lo:hi]}

    def _epi_view(self) -> dict:
        lo, hi = self.ranges[self.n_stages]
        return {"layers": self.caches["layers"][lo:hi]}

    def _ensure_stage_resident(self, s: int, mb: int) -> None:
        if self.stage_offloaders:
            self.stage_offloaders[s].ensure_resident(self._stage_view(s), mb)

    def _ensure_epi_resident(self, mb: int) -> None:
        if self.epilogue_offloader is not None:
            self.epilogue_offloader.ensure_resident(self._epi_view(), mb)

    def _prefill_residency(self, mb: int) -> None:
        # an exact prefill writes every layer's pools: every stage unit and
        # the epilogue
        for s in range(self.n_stages):
            self._ensure_stage_resident(s, mb)
        self._ensure_epi_resident(mb)

    @property
    def swap_count(self) -> int:
        epi = self.epilogue_offloader
        return sum(o.swap_count for o in self.stage_offloaders) + \
            (epi.swap_count if epi is not None else 0)

    # -- the prefill stepper -------------------------------------------------

    def prefill_can_accept(self) -> bool:
        return self._pf_entries[0] is None

    def prefill_pending(self) -> bool:
        return any(e is not None for e in self._pf_entries)

    def prefill_step(self, chunk: Optional[PrefillChunk]
                     ) -> List[PrefillResult]:
        entries = list(self._pf_entries)
        if chunk is not None:
            if entries[0] is not None:
                raise RuntimeError("prefill pipe stage 0 is occupied")
            entries[0] = chunk
        if not any(e is not None for e in entries):
            return []
        ref = next(e for e in entries if e is not None)
        rows, clen = ref.tokens.shape
        n_pages_row = ref.tables.shape[1]
        tokens = entries[0].tokens if entries[0] is not None \
            else np.zeros((rows, clen), np.int32)
        offs = np.zeros((self.n_stages, rows), np.int32)
        nval = np.zeros((self.n_stages, rows), np.int32)
        tabs = np.zeros((self.n_stages, rows, n_pages_row), np.int32)
        for s, e in enumerate(entries):
            if e is not None:
                offs[s], nval[s], tabs[s] = e.offsets, e.n_valid, e.tables
        drained = entries[-1]
        lasts = drained.lasts if drained is not None \
            else np.zeros((rows,), np.int32)
        # host inputs go to the card before any swap is enqueued (see
        # LocalBackend._residency)
        inputs = [self._tensor(a) for a in (tokens, offs, nval, tabs, lasts)]
        for s, e in enumerate(entries):
            for mb in (e.residency_mbs if e is not None else ()):
                self._ensure_stage_resident(s, mb)
        for mb in (drained.residency_mbs if drained is not None else ()):
            self._ensure_epi_resident(mb)
        occupied = [e is not None for e in entries]
        t0 = time.perf_counter()
        logits, self._pf_act = PL.pipeline_prefill_chunk_tick(
            self.params, self.caches, self._pf_act, *inputs,
            occupied=occupied, cfg=self.cfg, rt=self.rt,
            n_stages=self.n_stages, wire_dtype=self.wire_dtype)
        # the tick's device work ends inside the engine's prefill phase,
        # and the stage time the transport books is the card's
        self._sync()
        dt = time.perf_counter() - t0
        # the chunk activation (R, C, D) crosses each occupied boundary
        self.transport.tick(
            occupied, rows * clen * self.cfg.d_model * self._dtype_bytes,
            _stage_seconds(dt, occupied), plane="prefill")
        self._pf_entries = [None] + entries[:-1]
        if drained is None:
            return []
        return [PrefillResult(chunk=drained, logits=logits)]

    # -- the decode stepper ----------------------------------------------------

    def busy_microbatches(self) -> set:
        return {e[0] for e in self._entries if e is not None}

    def pending(self) -> bool:
        return any(e is not None for e in self._entries)

    def decode(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
               samp: RowSampling, active: bool = True) -> List[DecodeResult]:
        results: List[DecodeResult] = []
        if active and self.schedule == "round_flush" \
                and mb <= self._last_inject_mb:
            # vLLM-PP behaviour: the microbatch counter wrapped — a new
            # token round starts, so drain the pipe completely first
            # (fill/drain bubbles every round).  The drained results ride
            # back with this call; the engine books them by mb id.
            while self.pending():
                results += self._decode_tick(mb, tokens, cur_pos, samp,
                                             active=False)
            self._last_inject_mb = -1
        if active:
            self._last_inject_mb = mb
        return results + self._decode_tick(mb, tokens, cur_pos, samp,
                                           active=active)

    def _decode_tick(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
                     samp: RowSampling, active: bool) -> List[DecodeResult]:
        entries = list(self._entries)
        entries[0] = (mb, np.asarray(cur_pos, np.int32).copy(), samp) \
            if active else None
        if not any(e is not None for e in entries):
            return []
        self.decode_ticks += 1
        mb_assign = [e[0] if e is not None else -1 for e in entries]
        pos_stage = np.zeros((self.n_stages, self.mb_size), np.int32)
        for s, e in enumerate(entries):
            if e is not None:
                pos_stage[s] = e[1]
        drained = entries[-1]
        # sampling travels with the microbatch: the tick samples the
        # *draining* microbatch with the RowSampling captured at injection
        dsamp = drained[2] if drained is not None else None
        sampled = dsamp is not None and dsamp.any_sampled
        noise = gumbel_noise(dsamp, self.cfg.vocab_size, self.device,
                             self.noise_gen) if sampled else None
        samp_in = (dsamp.temp, dsamp.top_k, dsamp.top_p) \
            if dsamp is not None else (np.zeros((self.mb_size,), np.float32),
                                       np.zeros((self.mb_size,), np.int32),
                                       np.ones((self.mb_size,), np.float32))
        # host inputs go to the card before any swap is enqueued
        toks_in, pos_in, temp, top_k, top_p = [
            self._tensor(a) for a in (tokens, pos_stage) + samp_in]
        for s, e in enumerate(entries):
            if e is not None:
                self._ensure_stage_resident(s, e[0])
        if drained is not None:
            self._ensure_epi_resident(drained[0])
        t0 = time.perf_counter()
        toks, lps, self.act = PL.pipeline_decode_tick(
            self.params, self.caches, self.act, toks_in, pos_in,
            mb_assign=mb_assign, noise=noise, temp=temp, top_k=top_k,
            top_p=top_p, sampled=sampled, cfg=self.cfg, rt=self.rt,
            n_stages=self.n_stages, mb_size=self.mb_size,
            wire_dtype=self.wire_dtype)
        out = None
        if drained is not None:
            # §4.3 return link: the drained microbatch's token ids ride
            # back to the host injector — the tick's one device-to-host
            # transfer, which also ends its device work
            out = torch.stack([toks.float(), lps]).cpu().numpy()
        else:
            self._sync()            # the stage times below are the card's
        dt = time.perf_counter() - t0
        occupied = [e is not None for e in entries]
        self.decode_stage_runs += sum(occupied)
        # the (mb_size, 1, D) activation crosses each occupied boundary;
        # an injection may not start before its microbatch's previous
        # drain returned over the last link (the §4.3 dependency)
        obs = self.transport.tick(
            occupied, self.mb_size * self.cfg.d_model * self._dtype_bytes,
            _stage_seconds(dt, occupied),
            inject_t=self._ret_ready.get(mb, 0.0)
            if entries[0] is not None else 0.0, plane="decode")
        self._entries = [None] + entries[:-1]
        if drained is None:
            return []
        self.epilogue_runs += 1
        self._ret_ready[drained[0]] = obs.return_ready
        return [DecodeResult(mb=drained[0], tokens=out[0].astype(np.int32),
                             logprobs=out[1])]

    def transport_stats(self) -> Dict:
        return self.transport.stats()


def _stage_seconds(dt: float, occupied: Sequence[bool]) -> List[float]:
    """Each stage's compute seconds in a tick of ``dt`` seconds: the tick's
    time split evenly over the stages that ran.  The JAX tick runs every
    stage (a bubble's writes are masked), so its even split over all
    ``N_S`` stages is the same split; here a bubble does no work, so a
    tick that runs one stage of two is one stage's time, not two halves
    of it."""
    n = max(1, sum(occupied))
    return [dt / n if occ else 0.0 for occ in occupied]


def make_backend(kind, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, offloader=None, n_stages: int = 2,
                 mesh=None, transport=None, schedule: str = "circular",
                 wire_dtype: str = "fp32"):
    """Engine-side factory: ``kind`` is ``"local"``, ``"pipelined"``, or an
    already constructed backend (passed through).  Given an ``offloader``,
    the pipelined backend builds its own, one a stage, in the same swap
    mode."""
    if isinstance(kind, _SlotCacheBackend):
        return kind
    if kind == "local":
        if transport is not None or schedule != "circular" \
                or wire_dtype != "fp32":
            raise ValueError(
                "stage transports / schedules / wire codecs require the "
                "pipelined backend — the local backend has no stage "
                "boundaries for a link to cross")
        return LocalBackend(cfg, params, rt, mb_size=mb_size,
                            num_microbatches=num_microbatches, pool=pool,
                            device=device, offloader=offloader)
    if kind == "pipelined":
        return PipelinedBackend(
            cfg, params, rt, mb_size=mb_size,
            num_microbatches=num_microbatches, pool=pool, device=device,
            n_stages=n_stages, offload=offloader is not None,
            offload_async=offloader is None or offloader.async_swap,
            mesh=mesh, transport=transport, schedule=schedule,
            wire_dtype=wire_dtype)
    raise ValueError(f"unknown backend {kind!r} (want 'local'|'pipelined')")
