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

Resilience (DeServe's decentralised fleet, where GPUs drop out, straggle
or join mid-job): a ``fault_plan`` (pipelined backend, archs without
recurrent layers) drops or delays stage ticks, and the engine injects lost
work again with the same tokens at the same positions, so every stream
stays what it would have been; stage times feed a
:class:`repro_torch.distributed.elastic.StragglerMitigator`, whose
lightest weight narrows the per-tick prefill admission while a stage
straggles; :meth:`OfflineEngine.reshard` rebuilds the pipe with another
stage count mid-run.

Online serving (``serving.online.OnlineLLM`` on top): ``prefix_cache``
shares fully prefilled prompt blocks between requests (refcounted pages,
chunked prefill only), and ``slo`` (:class:`SLOConfig`) sheds prefill
admission while the smoothed tick time exceeds the inter-token target,
unless the oldest waiting request risks its time-to-first-token target.

Observability and audit: ``trace=`` attaches a
:class:`repro_torch.obs.trace.TraceRecorder` (step phases, request
traces, prefix / SLO / fault / reshard events; threaded through the
backend, its offloaders and its transport), and
:meth:`OfflineEngine.set_recorder` attaches or detaches one on a running
engine.  Beside the ``engine`` track's ``reap`` / ``prefill`` / ``decode``
phases, the engine records its own booking on the ``engine/host`` track
(``build_chunk``; ``apply_prefill``, the prefill results and the
activations; ``apply_decode``, the decode results with the page-table
pushes they made), and the backend the parts of its calls (``backend``
track, ``serving.backend``).  ``strict=`` (default: the
``REPRO_STRICT`` environment variable) a
:class:`repro_torch.analysis.invariants.EngineAuditor` that re-checks the
engine's host-side books after every submit, step and reshard.  Both read
host values only, and every call is gated on the recorder or auditor
being there, so neither adds a device sync or costs anything when off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import offload as offload_lib
from repro_torch.core import pipeline as PL
from repro_torch.core.scheduler import ScheduleChoice, plan_schedule
from repro_torch.distributed.elastic import (ElasticPlanner, MeshPlan,
                                             StragglerMitigator)
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime, make_layer_plan, \
    stage_device
from repro_torch.models.model import PAGED_KINDS
from repro_torch.obs.trace import ENGINE_HOST_TRACK
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.backend import (DecodeResult, PipelinedBackend,
                                         PrefillChunk, PrefillResult,
                                         make_backend, stage_devices)
from repro_torch.serving.request import (EngineStats, Request, SamplingParams,
                                         SequenceState, Status)
from repro_torch.serving.sampler import (RowSampling, gumbel_noise,
                                         request_seed, sample_batched,
                                         token_logprobs)

log = logging.getLogger(__name__)


def _strict_default(strict: Optional[bool]) -> bool:
    """``strict=None`` defers to the ``REPRO_STRICT`` env var (the test
    suite sets it to 1), so the invariant auditor guards every test run
    without every construction site opting in."""
    if strict is not None:
        return bool(strict)
    return os.environ.get("REPRO_STRICT", "") not in ("", "0")


def _resolve_trace(trace):
    """``trace=`` accepts: None/False (off — the hot path carries no
    recorder and pays nothing), True (a default-capacity
    :class:`~repro_torch.obs.trace.TraceRecorder`), an int (ring
    capacity), or an existing recorder instance (shared across engines /
    front ends)."""
    if trace is None or trace is False:
        return None
    from repro_torch.obs.trace import TraceRecorder
    if trace is True:
        return TraceRecorder()
    if isinstance(trace, TraceRecorder):
        return trace
    if isinstance(trace, int):
        return TraceRecorder(capacity=trace)
    raise ValueError(
        f"trace must be None/False/True, an int capacity, or a "
        f"TraceRecorder, got {trace!r}")


@dataclasses.dataclass
class SLOConfig:
    """Latency-SLO targets for online serving admission.

    The controller shapes the per-tick prefill token budget (the lever of
    ``max_prefill_tokens_per_tick``): while the engine's smoothed tick
    time exceeds ``itl_target_s`` (a decoding request's inter-token latency
    is one tick per microbatch round) admission sheds prefill down to
    ``floor_frac`` of the budget; once the oldest waiting request has been
    queued for half its ``ttft_target_s`` the whole budget comes back (a
    TTFT at risk needs prefill).  A zero target turns its half off."""
    ttft_target_s: float = 0.0
    itl_target_s: float = 0.0
    floor_frac: float = 0.25
    ewma_alpha: float = 0.2

    def validate(self) -> None:
        if self.ttft_target_s < 0 or self.itl_target_s < 0:
            raise ValueError("SLO targets must be >= 0")
        if not (0.0 < self.floor_frac <= 1.0):
            raise ValueError(
                f"floor_frac must be in (0, 1], got {self.floor_frac}")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")


class SLOController:
    """The budget shaper of :class:`SLOConfig` (host side, no device
    state)."""

    def __init__(self, cfg: SLOConfig):
        cfg.validate()
        self.cfg = cfg
        self.itl_ewma = 0.0

    def observe_tick(self, dt: float) -> None:
        """Feed one engine tick's wall seconds into the ITL estimate."""
        a = self.cfg.ewma_alpha
        self.itl_ewma = dt if self.itl_ewma == 0.0 else \
            (1.0 - a) * self.itl_ewma + a * dt

    def budget_frac(self, oldest_wait_s: float) -> float:
        """The fraction of the per-tick prefill token budget to admit."""
        c = self.cfg
        if c.ttft_target_s and oldest_wait_s >= 0.5 * c.ttft_target_s:
            return 1.0          # TTFT at risk: prefill must not starve
        if c.itl_target_s and self.itl_ewma > c.itl_target_s:
            return max(c.floor_frac, c.itl_target_s / self.itl_ewma)
        return 1.0


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
                 fault_plan=None, prefix_cache: bool = False,
                 slo: Optional[SLOConfig] = None, device=None, trace=None,
                 strict: Optional[bool] = None):
        # a lost tick is injected again with the same tokens at the same
        # positions, which is transparent only when every cache write is
        # keyed by position (paged KV, ring slots); a recurrent update
        # accumulates, and applying it twice would step the state twice
        if fault_plan is not None and cfg.recurrent_layer_count() > 0:
            raise ValueError(
                f"{cfg.name}: fault injection needs position-idempotent "
                "cache writes; recurrent layers accumulate state and "
                "cannot replay a lost tick without a state snapshot")
        self.cfg = cfg
        self.params = params
        self.rt = rt
        self.recorder = _resolve_trace(trace)
        self.device = stage_device(device)       # stage 0's
        self.mb_size = mb_size
        self.num_microbatches = num_microbatches
        self.batch = mb_size * num_microbatches
        self.pool = pool or kvc.PoolConfig()
        self.default_sampling = sampling or SamplingParams()
        self.seed = seed
        self.n_stages = n_stages
        self._offloader = offloader     # reshard builds the new pipe's own
        # the engine owns the placement by stage: the weights it was given
        # move in place to their stages' devices (nothing moves with
        # mesh=None or when they were drawn placed); the bytes moved by
        # the last placement, a reshard's caches included
        self.moved_bytes = 0
        if backend == "pipelined":
            self.moved_bytes = self._place(
                stage_devices(mesh, n_stages, self.device))
        self.backend = make_backend(
            backend, cfg, params, rt, mb_size=mb_size,
            num_microbatches=num_microbatches, pool=self.pool,
            device=self.device, offloader=offloader, n_stages=n_stages,
            mesh=mesh, transport=transport, schedule=schedule,
            wire_dtype=wire_dtype, fault_plan=fault_plan,
            recorder=self.recorder)
        # the devices reshard() may place stages on (None: every stage on
        # the engine's device), and the streams the engine's work goes to:
        # each stage card's current one at build time (``step`` and an
        # online pump thread enter them all)
        self.mesh = None if mesh is None else \
            list(self.backend.stage_devices)
        self.streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._capture_streams()

        # the elastic control plane: per-stage EWMA tick times (they narrow
        # the admission budget) and the planner bookkeeping that reshard()
        # updates; only a pipelined backend reports stage times
        stages = getattr(self.backend, "n_stages", None)
        self.straggler = StragglerMitigator(stages) if stages else None
        # lifetime per-stage observation totals (beside the EWMAs in the
        # report); reset with the mitigator on reshard
        self._stage_time_total = [0.0] * (stages or 0)
        self._stage_time_count = [0] * (stages or 0)
        self._elastic = ElasticPlanner(model_parallel=1, pod_size=1 << 30)
        self._mesh_plan = MeshPlan(shape=(stages or 1, 1),
                                   axes=("data", "model"),
                                   devices_used=stages or 1,
                                   devices_spare=0)

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

        # a prefix hit starts the chunk cursor mid-prompt, which the
        # exact-length path cannot do
        if prefix_cache and not self.chunked_prefill:
            raise ValueError(
                f"{cfg.name}: prefix_cache=True needs chunked prefill "
                "(fully-paged archs, prefill_mode != 'exact') — a prefix "
                "hit resumes prefill mid-prompt via the chunk cursor")
        self.prefix_cache: Optional[kvc.PrefixCache] = \
            kvc.PrefixCache(self.alloc) if prefix_cache else None
        self.slo: Optional[SLOController] = \
            SLOController(slo) if slo is not None else None

        self.queue: deque = deque()
        self.finished: List[SequenceState] = []
        self.stats = EngineStats()

        # strict mode: re-audit page accounting, the Status FSM, transport
        # books, offload parity and kernel libraries after every submit /
        # step / reshard — host bookkeeping only, no device syncs (see
        # repro_torch.analysis.invariants)
        self.strict = _strict_default(strict)
        if self.strict:
            from repro_torch.analysis.invariants import EngineAuditor
            self.auditor: Optional[EngineAuditor] = EngineAuditor(self)
        else:
            self.auditor = None

    def _place(self, devs: List[torch.device], caches=None) -> int:
        """Move the weights (and ``caches``, a reshard's) in place so that
        each stage's layers sit on its device in ``devs``
        (``models.model.place_params``, ``serving.kv_cache.place_caches``),
        one layer at a time; returns the bytes moved."""
        per_layer = PL.layer_devices(self.cfg, devs)
        moved = model_lib.place_params(self.params, per_layer)
        if caches is not None:
            moved += kvc.place_caches(caches, per_layer)
        return moved

    def _capture_streams(self) -> None:
        """Add the current stream of each stage card not seen before."""
        for dev in self.backend.stage_devices:
            if dev.type == "cuda" and dev not in self.streams:
                self.streams[dev] = torch.cuda.current_stream(dev)

    def stream_context(self):
        """A context that makes the engine's stream current on every stage
        card, stage 0's card last (so it is the current device): the
        engine's work, kernel launches and offload swaps included, stays
        in order on one stream a card whichever thread steps it."""
        stack = contextlib.ExitStack()
        for dev in sorted(self.streams, key=lambda d: d == self.device):
            stack.enter_context(torch.cuda.stream(self.streams[dev]))
        return stack

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
                  fault_plan=None, prefix_cache: bool = False,
                  slo: Optional[SLOConfig] = None,
                  device=None, trace=None,
                  strict: Optional[bool] = None) -> "OfflineEngine":
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
                  schedule=schedule, wire_dtype=wire_dtype,
                  fault_plan=fault_plan, prefix_cache=prefix_cache, slo=slo,
                  device=device, trace=trace, strict=strict)
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
            if self.recorder is not None:
                # the same float as seq.submit_time, so the trace's
                # queue-wait / TTFT math matches the engine's
                self.recorder.request_submit(r.request_id, now,
                                             len(r.prompt))
        self.stats.queue_depth = len(self.queue)
        if self.auditor is not None:
            self.auditor.after_submit()
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

    # ------------------------------------------------------------------
    # elastic re-sharding (the pipe's stage count changes mid-run)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def reshard(self, live_devices: Optional[int] = None, *,
                n_stages: Optional[int] = None, detector=None,
                now: Optional[float] = None) -> dict:
        """Rebuild the pipelined backend with another stage count mid-run,
        keeping every request's progress.

        The target is ``n_stages``, or the stage count that
        :class:`repro_torch.distributed.elastic.ElasticPlanner` derives
        from the live-device count (given, or read from a
        :class:`~repro_torch.distributed.elastic.FailureDetector` at
        ``now``): the largest power of two that the live devices, ``N_B``
        (N_B >= N_S), the layer plan's periods and the engine's mesh
        (``mesh=`` at build) admit.  The new stages take the mesh's first
        ``n_stages`` entries, as the JAX engine takes the first of
        ``jax.devices()``, and a target past its length raises.  With no
        mesh every stage stays on the engine's device and there is no
        device bound.

        Four steps: (1) drain both planes, so every tick in flight books
        as usual and nothing is computed twice; (2) export the
        offloaders' host stores (``export_offload_state``) into
        whole-model host tensors; (3) build the new ``PipelinedBackend``
        through ``make_backend``, on the same weights and caches, placed
        by the new stages first: a layer whose device changes moves
        device to device with its caches, one layer at a time, so no card
        holds two copies of the model (``moved_bytes`` counts them); with
        the transport retargeted by ``for_stages``, the same schedule and
        wire dtype, the plane tick counters carried (a FaultPlan tick
        keeps its meaning) and pending fault events for stages that no
        longer exist dropped; (4) import the stores into the
        new offloaders, push the page table to every stage card, and start
        a fresh :class:`StragglerMitigator`.  The sequences' cursors are
        engine state, so no token is generated twice.

        Returns the planner's resharding plan, with the time of each step
        under ``"seconds"`` and the host-store bytes carried under
        ``"bytes_migrated"``; raises on the local backend."""
        with self.stream_context():
            return self._reshard(live_devices, n_stages, detector, now)

    def _reshard(self, live_devices, n_stages, detector, now) -> dict:
        if not isinstance(self.backend, PipelinedBackend):
            raise ValueError(
                "reshard: only the pipelined backend has stages to rebuild "
                f"(backend is {self.backend.name!r})")
        if detector is not None:
            if now is None:
                now = time.monotonic()
            live_devices = len(detector.live(now))
        mesh = self.mesh
        if n_stages is None:
            if live_devices is None:
                raise ValueError(
                    "reshard: pass live_devices=, detector=, or n_stages=")
            plan = self._elastic.plan(live_devices)
            n_periods = make_layer_plan(self.cfg.num_layers,
                                        self.cfg.block_pattern).n_periods
            n_stages = max(1, min(plan.data, self.num_microbatches,
                                  n_periods, *([] if mesh is None
                                               else [len(mesh)])))
        if n_stages > self.num_microbatches:
            raise ValueError(
                f"reshard: N_B >= N_S requires n_stages <= "
                f"{self.num_microbatches}, got {n_stages}")
        if mesh is not None and n_stages > len(mesh):
            raise ValueError(
                f"reshard: the engine's mesh has {len(mesh)} device(s), "
                f"fewer than the {n_stages} stages asked for")
        new_plan = MeshPlan(shape=(n_stages, 1), axes=("data", "model"),
                            devices_used=n_stages,
                            devices_spare=max(0, (live_devices or n_stages)
                                              - n_stages))
        reshard_plan = self._elastic.resharding_plan(self._mesh_plan,
                                                     new_plan)
        old = self.backend

        # (1) drain both planes
        t0 = time.perf_counter()
        old_stages = old.n_stages
        tokens0 = np.zeros((self.mb_size,), np.int32)
        while old.pending():
            for res in old.decode(0, tokens0, tokens0,
                                  self._row_sampling(0, self.mb_size),
                                  active=False):
                self._apply_result(res)
        while old.prefill_pending():
            for res in old.prefill_step(None):
                self._apply_prefill_result(res)
        self._activate_ready()          # the pipe is empty: nothing busy
        t1 = time.perf_counter()
        # (2) the host stores, whole-model, while the caches are stable
        state = old.export_offload_state()
        t2 = time.perf_counter()
        if self.recorder is not None:
            self.recorder.reshard_span("drain", t0, t2,
                                       (("old_stages", old_stages),))
        # (3) the new pipe over the same caches
        fault_plan = old.fault_plan
        if fault_plan is not None:
            gone = [e for e in fault_plan.events if e.stage >= n_stages]
            if gone:
                log.warning("reshard: dropping %d pending fault event(s) "
                            "for stages >= %d: %s", len(gone), n_stages, gone)
                fault_plan.events = [e for e in fault_plan.events
                                     if e.stage < n_stages]
        log.info("reshard: %d -> %d stages (%s)", old.n_stages, n_stages,
                 {k: v for k, v in reshard_plan.items()
                  if k not in ("old", "new")})
        new_mesh = None if mesh is None else mesh[:n_stages]
        old.head = None         # the drained pipe's tied copy, if any
        # the drained pipe's graphs point at caches the placement below
        # may move: the new backend captures its own
        old.graphs.clear()
        self.moved_bytes = self._place(
            stage_devices(new_mesh, n_stages, self.device), old.caches)
        self.backend = make_backend(
            "pipelined", self.cfg, self.params, self.rt,
            mb_size=self.mb_size, num_microbatches=self.num_microbatches,
            pool=self.pool, device=self.device, offloader=self._offloader,
            n_stages=n_stages, mesh=new_mesh,
            transport=old.transport.for_stages(n_stages),
            schedule=old.schedule, wire_dtype=old.wire_dtype,
            fault_plan=fault_plan, caches=old.caches,
            recorder=self.recorder)
        self._capture_streams()
        self.backend.decode_ticks = old.decode_ticks
        self.backend.prefill_ticks = old.prefill_ticks
        del old
        t3 = time.perf_counter()
        # (4) the stores into the new offloaders, the table, the mitigator
        self.backend.import_offload_state(state)
        reshard_plan["bytes_migrated"] = sum(
            t.numel() * t.element_size() for t in state.values())
        del state
        self.backend.set_page_table(self.table)
        self.straggler = StragglerMitigator(n_stages)
        self._stage_time_total = [0.0] * n_stages
        self._stage_time_count = [0] * n_stages
        self.n_stages = n_stages
        self._mesh_plan = new_plan
        self.stats.reshards += 1
        t4 = time.perf_counter()
        reshard_plan["seconds"] = {"drain": t1 - t0, "export": t2 - t1,
                                   "rebuild": t3 - t2, "import": t4 - t3}
        if self.recorder is not None:
            self.recorder.reshard_span("rebuild", t2, t4,
                                       (("n_stages", n_stages),))
        if self.auditor is not None:
            self.auditor.after_reshard()
        return reshard_plan

    def set_recorder(self, recorder) -> None:
        """Attach a flight recorder to the running engine, or detach it
        (None); ``recorder`` takes the forms ``trace=`` takes.  The backend,
        its offloaders and a pipelined backend's transport record into it
        from their next call, and a reshard hands it to the backend it
        builds.  Requests submitted before the attach have no per-request
        trace."""
        self.recorder = _resolve_trace(recorder)
        self.backend.set_recorder(self.recorder)

    def _drain_stage_times(self) -> None:
        """Feed the backend's stage-time observations to the mitigator."""
        if self.straggler is None:
            return
        for s, dt in self.backend.drain_stage_times():
            self.straggler.observe(s, dt)
            self._stage_time_total[s] += dt
            self._stage_time_count[s] += 1

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine tick: reap finished, run the prefill phase (one
        budgeted chunk, or the exact-length admission), tick one
        microbatch.  Returns False when fully drained.  It runs under
        ``torch.inference_mode``: serving records nothing for autograd,
        and each operation costs the host less there (an eager decode
        tick is bound by the host's launches); and on the engine's stream
        of every stage card (``stream_context``)."""
        with self.stream_context():
            return self._step()

    def _step(self) -> bool:
        rec = self.recorder
        t0 = time.perf_counter()
        self._reap()
        tp = time.perf_counter()
        if self.chunked_prefill:
            chunk = self._build_chunk()
            if rec is not None:
                tb = time.perf_counter()
                rec.span("build_chunk", ENGINE_HOST_TRACK, tp, tb)
            results = self.backend.prefill_step(chunk)
            if rec is not None:
                tb = time.perf_counter()
            for res in results:
                self._apply_prefill_result(res)
            self._activate_ready()
            if rec is not None:
                rec.span("apply_prefill", ENGINE_HOST_TRACK, tb,
                         time.perf_counter())
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
            if rec is not None:
                rec.step_phase("reap", t0, tp, self.stats.steps)
                rec.step_phase("prefill", tp, tp2, self.stats.steps)
            if self.auditor is not None:
                self.auditor.after_step()
            return False
        self._decode_microbatch(self.stats.steps % self.num_microbatches)
        self._drain_stage_times()
        self.stats.steps += 1
        t1 = time.perf_counter()
        self.stats.decode_time_s += (tp - t0) + (t1 - tp2)
        self.stats.wall_time_s += t1 - t0
        if self.slo is not None:
            self.slo.observe_tick(t1 - t0)
        if rec is not None:
            # the stamps EngineStats takes anyway
            step = self.stats.steps - 1
            rec.step_phase("reap", t0, tp, step)
            rec.step_phase("prefill", tp, tp2, step)
            rec.step_phase("decode", tp2, t1, step)
        if self.auditor is not None:
            self.auditor.after_step()
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
                if self.recorder is not None:
                    reason = seq.finish_reason()
                    self.recorder.request_finish(
                        seq.request.request_id, now,
                        reason.value if reason is not None else None)
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
        shared: List[int] = []
        if self.prefix_cache is not None:
            # adopt the longest cached full-page prefix of the prompt: the
            # refcounts go up, and the chunk cursor starts past it
            shared = self.prefix_cache.match(seq.request.prompt)
            if shared:
                self.alloc.adopt(slot, shared)
        try:
            try:
                pages = self.alloc.allocate(slot, n_pages - len(shared),
                                            global_pool=gp)
            except MemoryError:
                # pool pressure: evict cold cached prefixes and retry once
                # before the caller's head-of-line retry
                if self.prefix_cache is None or \
                        not self.prefix_cache.evict(n_pages - len(shared)):
                    raise
                if self.recorder is not None:
                    self.recorder.prefix_event(
                        "evict", seq.request.request_id,
                        (n_pages - len(shared)) * self.pool.page_size,
                        time.perf_counter())
                pages = self.alloc.allocate(slot, n_pages - len(shared),
                                            global_pool=gp)
        except MemoryError:
            if shared:
                self.alloc.release(slot)
            raise
        has_global = any(p >= self.pool.n_local_pages for p in pages)
        seq.global_parity = gp if has_global else None
        seq.slot = slot
        seq.prefill_pos = len(shared) * self.pool.page_size
        if shared:
            self.stats.prefix_hits += 1
            self.stats.prefix_hit_tokens += seq.prefill_pos
        if self.recorder is not None:
            rid = seq.request.request_id
            now = time.perf_counter()
            self.recorder.request_admit(rid, now)
            self.recorder.request_pages(rid, n_pages)
            if shared:
                self.recorder.prefix_event("hit", rid, seq.prefill_pos, now)
                self.recorder.request_prefix_hit(rid, seq.prefill_pos)
        seq.status = Status.PREFILLING
        seq.budget = min(sp.max_new_tokens, cap - plen)
        self.slots[slot] = seq

    def _tick_prefill_rows(self) -> int:
        """This tick's admission width: ``prefill_rows``, narrowed while a
        pipeline stage straggles (the §4.3 ring tick is set by the slowest
        stage, so admission work must shrink with it: the mitigator's
        weights are mean-1 inverse EWMAs, and the lightest one scales the
        per-tick token budget, floored at one chunk), and by the SLO
        controller's fraction when one is configured; the stricter of the
        two wins.  The chunk's shape stays (``prefill_rows``,
        ``prefill_chunk``); only fewer rows fill."""
        w = 1.0
        if self.straggler is not None and self.straggler.stragglers():
            w = min(w, min(self.straggler.microbatch_weights()))
        if self.slo is not None:
            now = time.perf_counter()
            waits = [now - s.submit_time for s in self.queue]
            waits += [now - s.submit_time for s in self.prefilling
                      if not s.generated]
            frac = self.slo.budget_frac(max(waits, default=0.0))
            w = min(w, frac)
            if self.recorder is not None:
                self.recorder.slo_budget(
                    frac,
                    int(self.max_prefill_tokens_per_tick * min(1.0, w)),
                    now)
        if w >= 1.0:
            return self.prefill_rows
        budget = int(self.max_prefill_tokens_per_tick * min(1.0, w))
        return max(1, min(self.prefill_rows, budget // self.prefill_chunk))

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
        rows_cap = self._tick_prefill_rows()
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
            if self.recorder is not None:
                self.recorder.request_chunk(seq.request.request_id, take)
        return PrefillChunk(tokens=tokens, offsets=offsets,
                            n_valid=n_valid, lasts=lasts, tables=tables,
                            seqs=rows,
                            residency_mbs=tuple(m for m in parity_mb.values()
                                                if m is not None))

    def _apply_prefill_result(self, res: PrefillResult) -> None:
        if res.lost:
            # a stage fault dropped the chunk in the pipe: the cursors did
            # not move, so clearing the in-flight flag makes _build_chunk
            # emit the same chunk again; prompt-KV writes are keyed by
            # offset, so the retry rewrites the same pages with the same
            # values
            for seq in res.chunk.seqs:
                seq.chunk_inflight = False
            self.stats.prefill_chunks_lost += 1
            if self.recorder is not None:
                self.recorder.fault("recover", time.perf_counter(),
                                    (("plane", "prefill"),
                                     ("rows", len(res.chunk.seqs))))
            return
        for i, seq in enumerate(res.chunk.seqs):
            seq.chunk_inflight = False
            take = int(res.chunk.n_valid[i])
            seq.prefill_pos += take
            self.stats.prefill_tokens += take
            if seq.prefill_pos >= seq.prompt_len:
                self._sample_first_token(seq, seq.slot, res.logits[i])
                if self.prefix_cache is not None:
                    # register the prompt's written blocks for later
                    # sharers (an existing entry wins)
                    self.prefix_cache.insert(seq.request.prompt,
                                             self.alloc.pages_of(seq.slot))
                    if self.recorder is not None:
                        self.recorder.prefix_event(
                            "insert", seq.request.request_id,
                            seq.prompt_len, time.perf_counter())
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
        (``model.prefill``).  The bucket is the key of the backend's
        captured exact-prefill steps (``serving.step_graph``: one graph a
        bucket and stage, captured at the bucket's second call), as it is
        of the JAX package's ``_prefill_jits``; the padding is the JAX
        package's, so that both write the same rings (the padded-ring
        behaviour of ROADMAP Queue 3 included)."""
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
        dev = logits_row.device         # the last stage's
        logits = logits_row[None]
        noise = gumbel_noise(samp, logits.shape[-1], dev,
                             self.backend.noise_gen)
        first = sample_batched(
            logits, noise, torch.from_numpy(samp.temp).to(dev),
            torch.from_numpy(samp.top_k).to(dev),
            torch.from_numpy(samp.top_p).to(dev))
        first_lp = token_logprobs(logits, first)
        # repro-torch-audit: allow(host-sync) — first-token host booking, once per request at prefill completion
        # repro-audit: allow(host-sync) — first-token host booking, once per request at prefill completion
        tok, lp = first[0].item(), first_lp[0].item()
        if sp.logprobs:
            seq.logprobs = [lp]
        seq.generated.append(tok)
        seq.first_token_time = time.perf_counter()   # engine-side TTFT mark
        if self.recorder is not None:
            # the same float as seq.first_token_time: trace TTFT ==
            # seq.ttft_s
            rid = seq.request.request_id
            self.recorder.request_first_token(rid, seq.first_token_time)
            self.recorder.request_tokens(rid, 1, seq.first_token_time)
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
        rec = self.recorder
        ta = time.perf_counter() if rec is not None else 0.0
        pushes = 0
        for res in results:
            pushes += self._apply_result(res)
        if rec is not None:
            rec.span("apply_decode", ENGINE_HOST_TRACK, ta,
                     time.perf_counter(), data=(("pushes", pushes),))

    def _apply_result(self, res: DecodeResult) -> int:
        """Book one drained microbatch tick (possibly for an earlier
        microbatch than the one just injected: a pipe drains ``N_S − 1``
        ticks after injection) for the rows live at its injection.  A lost
        tick books nothing: the cursors only move on a drained result, so
        dropping the injection snapshot lets the round robin inject the
        microbatch again on its next turn, with the same tokens at the same
        positions, and the retry rewrites the same position-keyed KV and
        samples under the same ``(seed, request_id, token_idx)`` seeds.
        Returns the page-table pushes it made (one a row that crossed into
        a new page)."""
        if res.lost:
            self._inject_snap.pop(res.mb, None)
            self.stats.decode_ticks_lost += 1
            if self.recorder is not None:
                self.recorder.fault("recover", time.perf_counter(),
                                    (("plane", "decode"), ("mb", res.mb)))
            return 0
        lo = res.mb * self.mb_size
        pushes = 0
        snap = self._inject_snap.pop(res.mb, None)
        rec = self.recorder
        tnow = time.perf_counter() if rec is not None else 0.0
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
            if rec is not None:
                rec.request_tokens(seq.request.request_id, 1, tnow)
            need = self.cur_pos[slot] + 1
            have = len(self.alloc.pages_of(slot)) * self.pool.page_size
            if need > have:
                self.alloc.extend(slot, global_pool=self._global_pool(slot))
                self.table[slot] = self.alloc.table_row(slot)
                self.backend.set_page_table(self.table)
                pushes += 1
                if rec is not None:
                    rec.request_pages(seq.request.request_id, 1)
        return pushes

    # ------------------------------------------------------------------

    def request_trace(self, request_id: int) -> Optional[dict]:
        """Per-request flight-recorder snapshot (queue wait, TTFT,
        per-token inter-token latencies, chunk / page / prefix-hit
        counts).  ``None`` when tracing is off or the request has been
        evicted from the recorder's bounded table."""
        if self.recorder is None:
            return None
        return self.recorder.request_trace(request_id)

    def throughput_report(self) -> dict:
        """The run's books; a pipelined engine whose transport keeps books
        adds them under ``"transport"`` and, on a virtual clock, the decode
        tok/s on that clock (``"virtual_decode_tok_per_s"``).  ``"graphs"``
        holds the backend's captured steps: captures and replays, decode
        and prefill, by key kind, the exact-prefill buckets run eagerly at
        their first call, and the seconds spent capturing."""
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
            "decode_ticks_lost": self.stats.decode_ticks_lost,
            "prefill_chunks_lost": self.stats.prefill_chunks_lost,
            "reshards": self.stats.reshards,
            "mean_latency_steps":
                float(np.mean(lat_steps)) if lat_steps else 0.0,
            "mean_latency_s": float(np.mean(lat_s)) if lat_s else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
        }
        g = self.backend.graphs.stats()
        rep["graphs"] = {k: g[k] for k in (
            "decode_captures", "decode_replays", "prefill_captures",
            "prefill_replays", "captures_by_kind", "replays_by_kind",
            "eager_by_kind", "capture_s", "instantiate_s")}
        if self.prefix_cache is not None:
            rep["prefix_hits"] = self.stats.prefix_hits
            rep["prefix_hit_tokens"] = self.stats.prefix_hit_tokens
            rep["prefix_hit_rate"] = self.prefix_cache.hit_rate
            rep["prefix_cache_pages"] = len(self.prefix_cache)
        if self.straggler is not None:
            # the observations behind the admission weighting: per-stage
            # EWMAs, lifetime totals and counts, the mean-1 inverse weights
            # and the stages flagged now
            rep["stages"] = {
                "ewma_s": list(self.straggler.ewma),
                "total_s": list(self._stage_time_total),
                "counts": list(self._stage_time_count),
                "microbatch_weights": self.straggler.microbatch_weights(),
                "stragglers": self.straggler.stragglers(),
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
