"""Offline serving engine with continuous batching, chunked and
exact-length prefill (counterpart of ``repro.serving.engine.OfflineEngine``).

The engine owns ``N_B`` microbatches of ``mb_size`` decode slots.  Each
step reaps finished sequences, runs the prefill phase, and ticks one
microbatch of decode, round-robin.  Idle rows decode greedily on page 0
and their results are discarded.

The compute runs behind a backend (``serving.backend``): ``"local"`` (one
model call a tick) or ``"pipelined"`` (DeServe's §4.3 circular pipeline of
``n_stages`` stages, with a transport on each stage boundary, the
``"circular"`` or ``"round_flush"`` schedule and an ``"fp32"`` or
``"int8"`` wire).  A pipelined result drains ``N_S − 1`` ticks after its
injection, so the engine books it against the rows and sequences it
snapshotted at injection (``_inject_snap``), holds admission and
activation back from microbatches with a tick in flight, and keeps
stepping until both planes have drained.

The prefill phase is chunked when every layer is paged (``"attn"`` /
``"global"``) and ``prefill_mode`` is not ``"exact"``: one budgeted chunk
(up to ``prefill_rows`` prompts x ``prefill_chunk`` tokens) a step.
Prefilling slots stay parked on scratch page 0 in the device table (chunks
carry their own table rows); a slot's real row is pushed when its prefill
completes.  Otherwise (sliding-window and recurrent archs, whose rings and
states the chunk path cannot write, or ``prefill_mode="exact"``) a step
admits queued requests into every free slot, each with one exact-length
prefill of its whole prompt, padded to a multiple of 8, or to a power of
two when the arch has recurrent layers (``_prefill_len``).

Sampling is per request: each slot carries its temperature / top-k /
top-p and a base seed derived from ``(seed, request_id)``; token ``t``'s
noise comes from ``token_seed(base, t)`` (``serving.sampler``).

KV placement follows §4.2: microbatch ``m`` draws overflow pages from
global pool ``G_{m % 2}``, and the backend's
:class:`repro_torch.core.offload.DoubleBufferOffloader` keeps the pool of
the microbatch that is not computing in host memory.  A prefill chunk
carries rows of at most one microbatch per parity with global pages.
:meth:`OfflineEngine.from_plan` derives (N_B, per-microbatch batch, pool
split) from a measured stage time and link latency (§4.3).

Not in this slice (each later slice of the port brings its part): fault
plans, reshard, the prefix cache, SLO admission, the tracing recorder and
the strict auditor.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import offload as offload_lib
from repro_torch.core.scheduler import ScheduleChoice, plan_schedule
from repro_torch.models.common import Runtime, resolve_device
from repro_torch.models.model import PAGED_KINDS, check_supported
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.backend import (DecodeResult, PrefillChunk,
                                         PrefillResult, make_backend)
from repro_torch.serving.request import (EngineStats, Request, SamplingParams,
                                         SequenceState, Status)
from repro_torch.serving.sampler import (RowSampling, gumbel_noise,
                                         request_seed, sample_batched,
                                         token_logprobs)

log = logging.getLogger(__name__)


def prefill_chunk_cap(cfg: ModelConfig, rt: Runtime, link, *,
                      stage_time: float, wire_dtype: str = "fp32") -> int:
    """Bandwidth cap on the prefill chunk length, in tokens: the largest C
    whose wire time (C tokens of activations over the link's
    ``bandwidth_bps``) fits one stage tick, so a prefill chunk never
    stretches the cadence the §4.3 planner sized ``N_B`` for.  A token is
    ``d_model`` elements of the compute dtype on the wire, or ``d_model +
    4`` bytes packed int8 (one float32 row scale).  Returns 0 when there
    is nothing to cap (no link, or unlimited bandwidth)."""
    bw = getattr(link, "bandwidth_bps", 0.0) if link is not None else 0.0
    if not bw or stage_time <= 0:
        return 0
    if wire_dtype == "int8":
        token_bytes = cfg.d_model + 4
    else:
        token_bytes = cfg.d_model * torch.empty(
            (), dtype=rt.compute_dtype).element_size()
    return max(1, int(stage_time * bw // token_bytes))


class OfflineEngine:
    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int = 4, num_microbatches: int = 1,
                 pool: Optional[kvc.PoolConfig] = None,
                 sampling: Optional[SamplingParams] = None,
                 offloader=None, seed: int = 0, backend="local",
                 n_stages: int = 2, mesh=None,
                 prefill_chunk: int = 0, max_prefill_tokens_per_tick: int = 0,
                 prefill_mode: str = "auto", transport=None,
                 schedule: str = "circular", wire_dtype: str = "fp32",
                 device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.rt = rt
        self.device = resolve_device(device)
        self.mb_size = mb_size
        self.num_microbatches = num_microbatches
        self.batch = mb_size * num_microbatches
        self.pool = pool or kvc.PoolConfig()
        self.default_sampling = sampling or SamplingParams()
        self.seed = seed
        self.n_stages = n_stages
        self.backend = make_backend(
            backend, cfg, params, rt, mb_size=mb_size,
            num_microbatches=num_microbatches, pool=self.pool,
            device=self.device, offloader=offloader, n_stages=n_stages,
            mesh=mesh, transport=transport, schedule=schedule,
            wire_dtype=wire_dtype)

        self.alloc = kvc.PageAllocator(self.pool)
        self.table = np.zeros((self.batch, self.pool.max_pages_per_seq),
                              np.int32)
        self.cur_pos = np.zeros((self.batch,), np.int32)   # next position
        self.active = np.zeros((self.batch,), bool)
        self.slots: List[Optional[SequenceState]] = [None] * self.batch
        # per-slot sampling state (set at first token, benign when idle)
        self.samp_keys = np.zeros((self.batch,), np.int64)
        self.samp_temp = np.zeros((self.batch,), np.float32)
        self.samp_top_k = np.zeros((self.batch,), np.int32)
        self.samp_top_p = np.ones((self.batch,), np.float32)

        # chunked prefill writes through per-chunk page-table rows, so it
        # needs every layer's KV in the shared pools; sliding-window rings
        # and recurrent states take the exact-length path
        supports_chunked = all(k in PAGED_KINDS for k in cfg.layer_kinds())
        if prefill_mode not in ("auto", "chunked", "exact"):
            raise ValueError(
                f"prefill_mode must be 'auto'|'chunked'|'exact', "
                f"got {prefill_mode!r}")
        if prefill_mode == "chunked" and not supports_chunked:
            raise ValueError(
                f"{cfg.name}: prefill_mode='chunked' needs every layer kind "
                "to be paged ('attn'/'global'); recurrent and sliding-window "
                "archs must use exact-length prefill")
        self.chunked_prefill = supports_chunked and prefill_mode != "exact"
        cap = self.pool.max_pages_per_seq * self.pool.page_size
        if not prefill_chunk:           # default chunk: 32 tokens, shrunk
            prefill_chunk = min(32,     # to an explicit per-tick budget
                                max_prefill_tokens_per_tick or 32)
        self.prefill_chunk = min(cap, prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {self.prefill_chunk}")
        budget = max_prefill_tokens_per_tick or self.prefill_chunk
        if budget < self.prefill_chunk:
            raise ValueError(
                f"max_prefill_tokens_per_tick={budget} < prefill_chunk="
                f"{self.prefill_chunk}: the per-tick budget must fit at "
                "least one chunk")
        self.max_prefill_tokens_per_tick = budget
        self.prefill_rows = max(1, budget // self.prefill_chunk)
        self.prefilling: List[SequenceState] = []   # own a slot, not done
        self._pending_activation: List[SequenceState] = []
        self._inject_snap: Dict[int, tuple] = {}    # mb -> (active, seqs)
                                                    # at decode injection

        self.queue: deque = deque()
        self.finished: List[SequenceState] = []
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    # planned construction (DeServe §4.3: N_B, batch, pools from the link)
    # ------------------------------------------------------------------

    @classmethod
    def from_plan(cls, cfg: ModelConfig, params: dict, rt: Runtime, *,
                  n_stages: int, stage_time: float, latency: float,
                  m_kv_bytes: float, page_size: int = 16,
                  max_pages_per_seq: int = 16, bandwidth: float = 0.0,
                  use_offload: bool = True, max_microbatches: int = 64,
                  choice: Optional[ScheduleChoice] = None,
                  mb_size_cap: int = 0,
                  sampling: Optional[SamplingParams] = None, seed: int = 0,
                  prefill_chunk: int = 0,
                  max_prefill_tokens_per_tick: int = 0,
                  prefill_mode: str = "auto", worst_link=None,
                  link_latencies=None, offload_async: bool = True,
                  backend="local", mesh=None, transport=None,
                  schedule: str = "circular", wire_dtype: str = "fp32",
                  device=None) -> "OfflineEngine":
        """An engine whose (N_B, per-microbatch batch, pool split) are
        derived from a measured stage time and link latency by
        :func:`repro_torch.core.scheduler.plan_schedule`, as
        ``repro.serving.engine.OfflineEngine.from_plan`` derives them.

        ``m_kv_bytes`` is the per-stage KV budget; ``bandwidth`` the swap
        rate (0 = the paper's ``PCIE4_BW``); ``choice`` a precomputed
        :class:`ScheduleChoice`, honoured as it is; ``mb_size_cap`` bounds
        the per-microbatch batch; ``link_latencies`` (one a ring link)
        replace the scalar ``latency`` in the planner; ``worst_link`` (a
        :class:`repro_torch.distributed.transport.LinkSpec`) caps the
        prefill chunk.  ``backend`` and the pipe's knobs go to the engine
        as they are.  Prefer
        :meth:`repro_torch.serving.llm.EngineConfig.plan`."""
        if not bandwidth:
            bandwidth = offload_lib.PCIE4_BW
        page_bytes = kvc.kv_bytes_per_page(
            cfg, kvc.PoolConfig(page_size=page_size),
            dtype_bytes=torch.empty((), dtype=rt.compute_dtype
                                    ).element_size())
        if page_bytes == 0:
            raise ValueError(
                f"{cfg.name}: from_plan needs at least one paged-attention "
                "layer (pure-recurrent archs have no KV pools to plan)")
        kv_bytes_per_seq = page_bytes * max_pages_per_seq
        if choice is None:
            choice = plan_schedule(
                n_stages=n_stages, stage_time=stage_time, latency=latency,
                link_latencies=link_latencies, m_kv_bytes=m_kv_bytes,
                kv_bytes_per_seq=kv_bytes_per_seq,
                offload_bandwidth=bandwidth, use_offload=use_offload,
                max_microbatches=max_microbatches)
        if choice.offload:
            pool = offload_lib.OffloadPlan.derive(
                m_kv_bytes=m_kv_bytes, page_bytes=page_bytes,
                page_size=page_size, max_pages_per_seq=max_pages_per_seq,
                bandwidth=bandwidth, stage_time=stage_time,
                n_microbatches=choice.n_microbatches).pool
        else:
            pool = kvc.PoolConfig(
                page_size=page_size,
                n_local_pages=max(2, int(m_kv_bytes // page_bytes)),
                n_global_pages=0, max_pages_per_seq=max_pages_per_seq)
        mb_size = max(1, choice.per_mb_batch)
        if mb_size_cap:
            mb_size = min(mb_size, mb_size_cap)
        offloader = None
        if choice.offload and pool.n_global_pages:
            offloader = offload_lib.DoubleBufferOffloader(
                pool, choice.n_microbatches, async_swap=offload_async)
        if not prefill_chunk:
            # a prefill token costs the model FLOPs of a decode token, so a
            # chunk of about the per-microbatch batch costs at most one
            # decode tick of stage time (floored at 8), shrunk further when
            # a link's wire time would stretch the tick
            prefill_chunk = max(8, mb_size)
            cap = prefill_chunk_cap(cfg, rt, worst_link,
                                    stage_time=stage_time,
                                    wire_dtype=wire_dtype)
            if cap and cap < prefill_chunk:
                prefill_chunk = cap
        eng = cls(cfg, params, rt, mb_size=mb_size,
                  num_microbatches=choice.n_microbatches, pool=pool,
                  sampling=sampling, offloader=offloader, seed=seed,
                  backend=backend, n_stages=n_stages, mesh=mesh,
                  prefill_chunk=prefill_chunk,
                  max_prefill_tokens_per_tick=max_prefill_tokens_per_tick,
                  prefill_mode=prefill_mode, transport=transport,
                  schedule=schedule, wire_dtype=wire_dtype, device=device)
        eng.schedule_choice = choice
        return eng

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, requests: List[Request]) -> List[SequenceState]:
        cap = self.pool.max_pages_per_seq * self.pool.page_size
        resolved = []
        for r in requests:          # validate all before enqueueing any
            sp = dataclasses.replace(r.sampling if r.sampling is not None
                                     else self.default_sampling)
            sp.validate()
            resolved.append(sp)
            if not r.prompt:
                raise ValueError(f"request {r.request_id}: empty prompt")
            if len(r.prompt) >= cap:
                raise ValueError(
                    f"request {r.request_id}: prompt length {len(r.prompt)} "
                    f">= per-sequence KV capacity {cap} tokens "
                    f"(max_pages_per_seq={self.pool.max_pages_per_seq} x "
                    f"page_size={self.pool.page_size})")
        now = time.perf_counter()
        seqs = []
        for r, sp in zip(requests, resolved):
            seq = SequenceState(request=r, sampling=sp,
                                submit_step=self.stats.steps, submit_time=now)
            self.queue.append(seq)
            seqs.append(seq)
        self.stats.queue_depth = len(self.queue)
        return seqs

    def run(self, max_steps: int = 10_000) -> List[SequenceState]:
        """Step until drained (or ``max_steps``); returns finished
        sequences.  Exhausting the budget with work pending sets
        ``stats.aborted``."""
        self.stats.aborted = False
        for _ in range(max_steps):
            if not self.step():
                return self.finished
        if self.pending():
            self.stats.aborted = True
            log.warning("OfflineEngine.run(max_steps=%d) exhausted its step "
                        "budget with %d request(s) pending", max_steps,
                        len(self.pending()))
        return self.finished

    def pending(self) -> List[SequenceState]:
        """Sequences submitted but not finished (queued or in a slot)."""
        return [s for s in self.slots if s is not None] + list(self.queue)

    def status_counts(self) -> Dict[str, int]:
        counts = {s.value: 0 for s in Status}
        for seq in self.pending():
            counts[seq.status.value] += 1
        counts[Status.FINISHED.value] += len(self.finished)
        self.stats.status_counts = counts
        return counts

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine tick: reap finished, run the prefill phase (one
        budgeted chunk, or the exact-length admission), tick one
        microbatch.  Returns False when fully drained.  It runs under
        ``torch.inference_mode``: serving records nothing for autograd,
        and each operation costs the host less there (an eager decode
        tick is bound by the host's launches)."""
        t0 = time.perf_counter()
        self._reap()
        tp = time.perf_counter()
        if self.chunked_prefill:
            chunk = self._build_chunk()
            for res in self.backend.prefill_step(chunk):
                self._apply_prefill_result(res)
            self._activate_ready()
        else:
            self._admit()
        tp2 = time.perf_counter()
        self.stats.queue_depth = len(self.queue)
        self.stats.prefill_time_s += tp2 - tp
        # drained iff no slot is occupied, nothing is queued, and neither
        # plane of the backend has a tick in flight
        if not any(s is not None for s in self.slots) and not self.queue \
                and not self.backend.pending() \
                and not self.backend.prefill_pending():
            self.stats.decode_time_s += tp - t0
            self.stats.wall_time_s += time.perf_counter() - t0
            return False
        self._decode_microbatch(self.stats.steps % self.num_microbatches)
        self.stats.steps += 1
        t1 = time.perf_counter()
        self.stats.decode_time_s += (tp - t0) + (t1 - tp2)
        self.stats.wall_time_s += t1 - t0
        return True

    # ------------------------------------------------------------------
    # slot management
    # ------------------------------------------------------------------

    def _mb_of_slot(self, slot: int) -> int:
        return slot // self.mb_size

    def _reap(self) -> None:
        changed = False
        now = time.perf_counter()
        for slot, seq in enumerate(self.slots):
            if seq is not None and seq.is_done():
                seq.status = Status.FINISHED
                seq.finish_step = self.stats.steps
                seq.finish_time = now
                self.finished.append(seq)
                self.stats.finished_requests += 1
                self.alloc.release(slot)
                self.slots[slot] = None
                self.active[slot] = False
                self.table[slot] = 0            # park on scratch page 0
                self.cur_pos[slot] = 0
                self.samp_temp[slot] = 0.0      # idle rows decode greedily
                self.samp_top_k[slot] = 0
                self.samp_top_p[slot] = 1.0
                self.samp_keys[slot] = 0
                changed = True
        if changed:
            self.backend.set_page_table(self.table)

    def _admit(self) -> None:
        """Exact-length admission: prefill queued requests into every free
        slot, in queue order, except the slots of microbatches with a
        decode tick in flight (their cache rows must not be rewritten under
        it).  On page exhaustion the request goes back to the queue front
        and retries next step."""
        busy = self.backend.busy_microbatches()
        for slot in range(self.batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            if self._mb_of_slot(slot) in busy:
                continue
            seq = self.queue.popleft()
            seq.status = Status.PREFILLING
            try:
                self._prefill_into_slot(seq, slot)
            except MemoryError:
                seq.status = Status.QUEUED
                self.queue.appendleft(seq)      # retry when pages free up
                break

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------

    def _global_pool(self, slot: int) -> Optional[int]:
        """The global-pool parity a slot's overflow pages come from (None
        when the pools have no global pages)."""
        return self._mb_of_slot(slot) % 2 if self.pool.n_global_pages \
            else None

    def _allocate_slot(self, seq: SequenceState, slot: int) -> None:
        """Allocate the slot's full page budget, local pages first and the
        overflow from its microbatch's global pool, and bind the sequence
        to it (MemoryError with nothing bound on exhaustion).  The caller
        decides when to push the slot's real table row: the chunked path
        parks it until activation, the exact path pushes it at once."""
        sp = seq.sampling
        plen = seq.prompt_len
        cap = self.pool.max_pages_per_seq * self.pool.page_size
        n_pages = -(-min(plen + sp.max_new_tokens, cap) // self.pool.page_size)
        gp = self._global_pool(slot)
        pages = self.alloc.allocate(slot, n_pages, global_pool=gp)
        has_global = any(p >= self.pool.n_local_pages for p in pages)
        seq.global_parity = gp if has_global else None
        seq.slot = slot
        seq.prefill_pos = 0
        seq.status = Status.PREFILLING
        seq.budget = min(sp.max_new_tokens, cap - plen)
        self.slots[slot] = seq

    def _build_chunk(self) -> Optional[PrefillChunk]:
        """This tick's prefill work: continue partially prefilled sequences
        first (FIFO), then admit queued prompts into free slots, up to
        ``prefill_rows`` rows of ``prefill_chunk`` tokens.  Head-of-line
        blocking on page exhaustion: the queue front retries next tick.
        The offloader keeps one microbatch's copy of each global-pool
        parity resident, so the rows that draw on one parity all belong to
        one microbatch (one per parity rides along).  Nothing is built while
        the prefill pipe's first stage is occupied."""
        if not self.backend.prefill_can_accept():
            return None
        rows_cap = self.prefill_rows
        rows: List[SequenceState] = []
        # parity -> the one microbatch whose global pool this chunk writes
        parity_mb: Dict[int, Optional[int]] = {0: None, 1: None}
        for seq in self.prefilling:
            if len(rows) == rows_cap:
                break
            if seq.chunk_inflight:
                continue
            mb = self._mb_of_slot(seq.slot)
            if seq.global_parity is not None:
                if parity_mb[mb % 2] not in (None, mb):
                    continue            # another mb owns this parity slice
                parity_mb[mb % 2] = mb
            rows.append(seq)
        if len(rows) < rows_cap and self.queue:
            for slot in range(self.batch):
                if not self.queue or len(rows) == rows_cap:
                    break
                if self.slots[slot] is not None:
                    continue
                mb = self._mb_of_slot(slot)
                gp = self._global_pool(slot)
                if gp is not None and parity_mb[gp] not in (None, mb):
                    continue            # the slot would need the other mb's
                seq = self.queue[0]     # copy of this parity
                try:
                    self._allocate_slot(seq, slot)
                except MemoryError:
                    break               # head-of-line retry next tick
                self.queue.popleft()
                if seq.global_parity is not None:
                    parity_mb[gp] = mb
                self.prefilling.append(seq)
                rows.append(seq)
        if not rows:
            return None

        R, C = self.prefill_rows, self.prefill_chunk
        tokens = np.zeros((R, C), np.int32)
        offsets = np.zeros((R,), np.int32)
        n_valid = np.zeros((R,), np.int32)
        lasts = np.full((R,), -1, np.int32)
        tables = np.zeros((R, self.pool.max_pages_per_seq), np.int32)
        for i, seq in enumerate(rows):
            prompt = seq.request.prompt
            take = min(C, len(prompt) - seq.prefill_pos)
            tokens[i, :take] = prompt[seq.prefill_pos:seq.prefill_pos + take]
            offsets[i] = seq.prefill_pos
            n_valid[i] = take
            if seq.prefill_pos + take == len(prompt):
                lasts[i] = take - 1
            tables[i] = self.alloc.table_row(seq.slot)
            seq.chunk_inflight = True
        return PrefillChunk(tokens=tokens, offsets=offsets,
                            n_valid=n_valid, lasts=lasts, tables=tables,
                            seqs=rows,
                            residency_mbs=tuple(m for m in parity_mb.values()
                                                if m is not None))

    def _apply_prefill_result(self, res: PrefillResult) -> None:
        for i, seq in enumerate(res.chunk.seqs):
            seq.chunk_inflight = False
            take = int(res.chunk.n_valid[i])
            seq.prefill_pos += take
            self.stats.prefill_tokens += take
            if seq.prefill_pos >= seq.prompt_len:
                self._sample_first_token(seq, seq.slot, res.logits[i])
                self.prefilling.remove(seq)
                if not seq.is_done():       # finished at prefill: reap
                    self._pending_activation.append(seq)  # without decoding

    def _activate_ready(self) -> None:
        """Push real page-table rows and activate completed prefills whose
        microbatch has no decode tick in flight (an in-flight tick still
        writes its idle rows through the parked table row; swapping the
        row under it would clobber the fresh prompt KV at position 0)."""
        if not self._pending_activation:
            return
        busy = self.backend.busy_microbatches()
        held, changed = [], False
        for seq in self._pending_activation:
            if self._mb_of_slot(seq.slot) in busy:
                held.append(seq)
                continue
            self.table[seq.slot] = self.alloc.table_row(seq.slot)
            seq.status = Status.DECODING
            self.active[seq.slot] = True
            changed = True
        self._pending_activation = held
        if changed:
            self.backend.set_page_table(self.table)

    # ------------------------------------------------------------------
    # exact-length prefill (sliding-window archs, or prefill_mode="exact")
    # ------------------------------------------------------------------

    def _prefill_len(self, n: int) -> int:
        """Prompt length padded to a multiple of 8 (at least 8), or, for an
        arch with recurrent layers, to the next power of two (at least 8),
        as the JAX engine pads them.  The pad positions are marked -1, so
        the rings drop their writes and the recurrences step over them
        (``model.prefill``).  The port compiles nothing per shape; it pads
        as the JAX package does so that both write the same rings (the
        padded-ring behaviour of ROADMAP Queue 3 included)."""
        if self.cfg.recurrent_layer_count() > 0:
            return max(8, 1 << (n - 1).bit_length())
        return max(8, (n + 7) // 8 * 8)

    def _prefill_into_slot(self, seq: SequenceState, slot: int) -> None:
        prompt = seq.request.prompt
        plen = len(prompt)
        self._allocate_slot(seq, slot)          # pages + budget + binding
        self.table[slot] = self.alloc.table_row(slot)
        self.backend.reset_slot(slot)
        self.backend.set_page_table(self.table)

        toks = np.zeros((self._prefill_len(plen),), np.int32)
        toks[:plen] = prompt
        logits = self.backend.prefill(
            toks, slot, plen - 1,
            has_global_pages=seq.global_parity is not None)
        self._sample_first_token(seq, slot, logits)
        seq.status = Status.DECODING
        self.active[slot] = True
        self.stats.prefill_tokens += plen

    def _sample_first_token(self, seq: SequenceState, slot: int,
                            logits_row: torch.Tensor) -> None:
        """Set the slot's sampling state and sample the request's first
        token from its last-position prefill logits (token index 0), the
        same path as every decode token.  Shared by the chunked and exact
        prefill paths."""
        sp = seq.sampling
        self.samp_keys[slot] = request_seed(self.seed, seq.request.request_id)
        self.samp_temp[slot] = sp.temperature
        self.samp_top_k[slot] = sp.top_k
        self.samp_top_p[slot] = sp.top_p
        samp = RowSampling(keys=self.samp_keys[slot:slot + 1].copy(),
                           steps=np.zeros((1,), np.int32),
                           temp=self.samp_temp[slot:slot + 1].copy(),
                           top_k=self.samp_top_k[slot:slot + 1].copy(),
                           top_p=self.samp_top_p[slot:slot + 1].copy())
        dev = self.device
        logits = logits_row[None]
        noise = gumbel_noise(samp, logits.shape[-1], dev,
                             self.backend.noise_gen)
        first = sample_batched(
            logits, noise, torch.from_numpy(samp.temp).to(dev),
            torch.from_numpy(samp.top_k).to(dev),
            torch.from_numpy(samp.top_p).to(dev))
        first_lp = token_logprobs(logits, first)
        # repro-audit: allow(host-sync) — first-token host booking, once per request at prefill completion
        tok, lp = first[0].item(), first_lp[0].item()
        if sp.logprobs:
            seq.logprobs = [lp]
        seq.generated.append(tok)
        seq.first_token_time = time.perf_counter()   # engine-side TTFT mark
        self.cur_pos[slot] = seq.prompt_len     # position of the first token
        self.stats.decode_tokens += 1

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _row_sampling(self, lo: int, hi: int) -> RowSampling:
        """The per-row sampling state of slots [lo, hi), copied: a
        pipelined backend holds it until the tick drains."""
        steps = np.zeros((hi - lo,), np.int32)
        for i, slot in enumerate(range(lo, hi)):
            seq = self.slots[slot]
            if seq is not None:
                steps[i] = len(seq.generated)   # index of the token sampled
        return RowSampling(keys=self.samp_keys[lo:hi].copy(), steps=steps,
                           temp=self.samp_temp[lo:hi].copy(),
                           top_k=self.samp_top_k[lo:hi].copy(),
                           top_p=self.samp_top_p[lo:hi].copy())

    def _decode_microbatch(self, mb: int) -> None:
        """Inject microbatch ``mb`` when it has live rows; tick a pipe that
        still holds entries even when it has none (a tick that only
        drains)."""
        lo = mb * self.mb_size
        hi = lo + self.mb_size
        mb_active = bool(self.active[lo:hi].any())
        if not mb_active and not self.backend.pending():
            return
        tokens = np.zeros((self.mb_size,), np.int32)
        for i, slot in enumerate(range(lo, hi)):
            seq = self.slots[slot]
            if seq is not None and seq.generated:
                tokens[i] = seq.generated[-1]
        if mb_active:
            # which rows (and which sequences) this injection is for: a
            # slot can be reassigned, or become active, while its tick is
            # still in flight, and the drained result must never be booked
            # against the new occupant
            self._inject_snap[mb] = (self.active[lo:hi].copy(),
                                     list(self.slots[lo:hi]))
        results = self.backend.decode(mb, tokens, self.cur_pos[lo:hi],
                                      self._row_sampling(lo, hi),
                                      active=mb_active)
        self.stats.swaps = self.backend.swap_count
        for res in results:
            self._apply_result(res)

    def _apply_result(self, res: DecodeResult) -> None:
        """Book one drained microbatch tick (possibly for an earlier
        microbatch than the one just injected: a pipe drains ``N_S − 1``
        ticks after injection) for the rows live at its injection."""
        lo = res.mb * self.mb_size
        snap = self._inject_snap.pop(res.mb, None)
        for i, slot in enumerate(range(lo, lo + self.mb_size)):
            seq = self.slots[slot]
            if seq is None or seq.is_done():
                continue            # finished at prefill: reap next tick
            if snap is not None and (not snap[0][i] or snap[1][i] is not seq):
                continue            # not live at injection (still
                                    # prefilling, or the slot reassigned)
            seq.generated.append(int(res.tokens[i]))
            if seq.logprobs is not None:
                seq.logprobs.append(float(res.logprobs[i]))
            self.cur_pos[slot] += 1
            self.stats.decode_tokens += 1
            need = self.cur_pos[slot] + 1
            have = len(self.alloc.pages_of(slot)) * self.pool.page_size
            if need > have:
                self.alloc.extend(slot, global_pool=self._global_pool(slot))
                self.table[slot] = self.alloc.table_row(slot)
                self.backend.set_page_table(self.table)

    # ------------------------------------------------------------------

    def throughput_report(self) -> dict:
        """The run's books; a pipelined engine whose transport keeps books
        adds them under ``"transport"`` and, on a virtual clock, the decode
        tok/s on that clock (``"virtual_decode_tok_per_s"``)."""
        lat_steps = [s.latency_steps for s in self.finished
                     if s.latency_steps is not None]
        lat_s = [s.latency_s for s in self.finished
                 if s.latency_s is not None]
        ttft = [s.ttft_s for s in self.finished if s.ttft_s is not None]
        self.status_counts()
        rep = {
            "backend": self.backend.name,
            "device": str(self.device),
            "prefill_tokens": self.stats.prefill_tokens,
            "decode_tokens": self.stats.decode_tokens,
            "total_tokens": self.stats.total_tokens,
            "finished": self.stats.finished_requests,
            "steps": self.stats.steps,
            "decode_ticks": self.backend.decode_ticks,
            "swaps": self.stats.swaps,
            "wall_time_s": self.stats.wall_time_s,
            "prefill_time_s": self.stats.prefill_time_s,
            "decode_time_s": self.stats.decode_time_s,
            "decode_tok_per_s": self.stats.decode_tok_per_s,
            "prefill_tok_per_s": self.stats.prefill_tok_per_s,
            "queue_depth": self.stats.queue_depth,
            "status_counts": self.stats.status_counts,
            "aborted": self.stats.aborted,
            "mean_latency_steps":
                float(np.mean(lat_steps)) if lat_steps else 0.0,
            "mean_latency_s": float(np.mean(lat_s)) if lat_s else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
        }
        tstats = self.backend.transport_stats()
        if tstats:
            rep["transport"] = tstats
            vt = tstats.get("virtual_time_s", 0.0)
            if vt > 0:
                # decode tok/s on the simulated network's clock: what the
                # latency curve compares across schedules
                rep["virtual_decode_tok_per_s"] = \
                    self.stats.decode_tokens / vt
        return rep
