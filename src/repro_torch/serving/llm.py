"""Per-request generation front end: ``LLM`` / ``EngineConfig`` /
``RequestOutput`` (counterpart of ``repro.serving.llm``).

    llm = LLM("yi-9b", config=EngineConfig(mb_size=2, num_microbatches=2))
    outs = llm.generate(prompts, SamplingParams(temperature=0.8, top_p=0.95))

``EngineConfig.plan(...)`` derives (N_B, per-microbatch batch, pool split)
from a measured stage time and link latency (or a multi-region
``deployment``) through the §4.3 planner; global pools are double-buffered
to host memory (§4.2) unless ``offload=False``.  ``backend="pipelined"``
serves through §4.3's circular pipeline of ``n_stages`` stages:

    llm = LLM("yi-9b", config=EngineConfig(
        backend="pipelined", n_stages=2, num_microbatches=4,
        transport=0.064, wire_dtype="int8"))

Resilience and online serving: ``fault_plan`` (a
:class:`repro_torch.distributed.elastic.FaultPlan`, pipelined backend)
drops or delays stage ticks and the engine recovers the lost work;
``prefix_cache=True`` shares prompt blocks between requests (chunked
prefill); ``slo=SLOConfig(...)`` shapes prefill admission for latency
targets; :class:`repro_torch.serving.online.OnlineLLM` submits while the
engine runs and streams tokens per tick.

Observability and audit: ``trace=True`` attaches a flight recorder
(``engine.recorder``; export it with
``repro_torch.obs.write_chrome_trace``) and fills
``RequestOutput.trace``; ``strict=True`` (default: the ``REPRO_STRICT``
environment variable) audits the engine's books after every submit, step
and reshard.

Runs on ``cuda`` unless ``device="cpu"`` is passed; with no GPU and no
explicit CPU request it raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.config import ModelConfig, get_arch, reduced_config
from repro_torch.core import pipeline as PL
from repro_torch.core.offload import DoubleBufferOffloader
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime, resolve_device
from repro_torch.serving.backend import stage_devices
from repro_torch.serving.engine import OfflineEngine, SLOConfig
from repro_torch.serving.kv_cache import PoolConfig
from repro_torch.serving.request import (Request, SamplingParams,
                                         SequenceState, Status)

@dataclass
class EngineConfig:
    """Everything needed to build an :class:`OfflineEngine`, validated.

    ``prefill_mode`` is
    ``"auto"`` (chunked where every layer is paged, else exact-length),
    ``"chunked"`` or ``"exact"``.  ``backend`` is ``"local"`` or
    ``"pipelined"``; the pipe's knobs are ``n_stages``, ``transport`` (a
    :class:`repro_torch.distributed.transport.Transport`, a latency in
    seconds for uniform simulated links, or a ``DeploymentPlan``),
    ``schedule`` (``"circular"`` or ``"round_flush"``), ``wire_dtype``
    (``"fp32"`` or ``"int8"``) and ``mesh`` (one torch device a stage,
    ``n_stages`` of them, stage 0 the engine's device; it may repeat one:
    each stage's weights, caches and offloader go on its device, and
    ``None`` puts every stage on the engine's device).
    ``fault_plan`` needs the pipelined backend, ``prefix_cache`` chunked
    prefill, and ``slo`` is an :class:`SLOConfig`.  ``trace`` is the
    flight recorder (None/False off, True a default-capacity
    :class:`repro_torch.obs.trace.TraceRecorder`, an int its ring
    capacity, or a recorder to share), ``strict`` the runtime invariant
    auditor (None follows ``REPRO_STRICT``).  Either set the knobs
    directly, or build the config with :meth:`plan`."""
    mb_size: int = 4                  # sequences per microbatch
    num_microbatches: int = 1         # N_B
    pool: Optional[PoolConfig] = None
    offload: bool = True              # double-buffer the global pools
                                      # (nothing to do when there are none)
    # swap on the offloader's copy stream (True) or block on the compute
    # stream after each swap-out (False: debugging and A/B runs)
    offload_async: bool = True
    seed: int = 0
    prefill_chunk: int = 0            # tokens per chunk (0 = 32)
    max_prefill_tokens_per_tick: int = 0   # per-tick budget (0 = one chunk)
    backend: str = "local"
    n_stages: int = 2
    mesh: Optional[object] = None
    transport: Optional[object] = None
    schedule: str = "circular"
    wire_dtype: str = "fp32"
    fault_plan: Optional[object] = None
    prefill_mode: str = "auto"
    prefix_cache: bool = False
    slo: Optional[object] = None
    trace: object = None
    strict: Optional[bool] = None
    plan_args: Optional[dict] = None  # set by .plan(); overrides mb_size /
                                      # num_microbatches / pool

    def __post_init__(self) -> None:
        if self.mb_size < 1:
            raise ValueError(f"mb_size must be >= 1, got {self.mb_size}")
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1, "
                             f"got {self.num_microbatches}")
        if self.prefill_mode not in ("auto", "chunked", "exact"):
            raise ValueError("prefill_mode must be 'auto'|'chunked'|'exact'"
                             f", got {self.prefill_mode!r}")
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, "
                             f"got {self.prefill_chunk}")
        if self.max_prefill_tokens_per_tick < 0:
            raise ValueError("max_prefill_tokens_per_tick must be >= 0, "
                             f"got {self.max_prefill_tokens_per_tick}")
        if self.backend not in ("local", "pipelined"):
            raise ValueError("backend must be 'local'|'pipelined', got "
                             f"{self.backend!r}")
        if self.plan_args is None and self.backend == "pipelined" \
                and self.num_microbatches < self.n_stages:
            raise ValueError(
                f"pipelined backend needs num_microbatches >= n_stages "
                f"(N_B >= N_S), got N_B={self.num_microbatches} < "
                f"N_S={self.n_stages}")
        if self.schedule not in ("circular", "round_flush"):
            raise ValueError("schedule must be 'circular'|'round_flush', "
                             f"got {self.schedule!r}")
        if self.wire_dtype not in ("fp32", "int8"):
            raise ValueError("wire_dtype must be 'fp32'|'int8', got "
                             f"{self.wire_dtype!r} (top-k stays wire-byte "
                             "accounting only)")
        if self.backend != "pipelined" and (self.transport is not None or
                                            self.schedule != "circular" or
                                            self.wire_dtype != "fp32" or
                                            self.mesh is not None):
            raise ValueError(
                "transport / schedule / wire_dtype / mesh require "
                "backend='pipelined' — the local backend has no stage "
                "boundaries for a link to cross")
        if self.mesh is not None:
            # the list's shape; whether its devices exist (and stage 0 is
            # the engine's) is checked when the engine is built
            self.mesh = [torch.device(d) for d in self.mesh]
            if len(self.mesh) != self.n_stages:
                raise ValueError(
                    f"mesh has {len(self.mesh)} device(s) for "
                    f"{self.n_stages} stage(s): one device a stage")
        if self.fault_plan is not None and self.backend != "pipelined":
            raise ValueError(
                "fault_plan requires backend='pipelined' — the local "
                "backend has no stages to drop")
        if self.prefix_cache and self.prefill_mode == "exact":
            raise ValueError(
                "prefix_cache=True needs chunked prefill (a prefix hit "
                "resumes prefill mid-prompt via the chunk cursor) — "
                "prefill_mode='exact' cannot share prompt blocks")
        if self.slo is not None:
            if not isinstance(self.slo, SLOConfig):
                raise ValueError(f"slo must be an SLOConfig, got "
                                 f"{self.slo!r}")
            self.slo.validate()

    @classmethod
    def plan(cls, *, n_stages: Optional[int] = None, stage_time: float,
             latency: Optional[float] = None, m_kv_bytes: float,
             page_size: int = 16, max_pages_per_seq: int = 16,
             bandwidth: float = 0.0, use_offload: bool = True,
             max_microbatches: int = 64, choice=None, mb_size_cap: int = 0,
             seed: int = 0, prefill_chunk: int = 0,
             max_prefill_tokens_per_tick: int = 0,
             prefill_mode: str = "auto", offload_async: bool = True,
             backend: str = "local", mesh=None,
             deployment: Optional[object] = None,
             transport: Optional[object] = None,
             schedule: str = "circular",
             wire_dtype: str = "fp32", fault_plan=None,
             prefix_cache: bool = False,
             slo: Optional[SLOConfig] = None, trace: object = None,
             strict: Optional[bool] = None) -> "EngineConfig":
        """A config whose (N_B, per-microbatch batch, pool split) are
        derived by :func:`repro_torch.core.scheduler.plan_schedule` at
        build time (``OfflineEngine.from_plan``).  ``prefill_chunk=0``
        derives the chunk from the plan: about the per-microbatch decode
        batch, so one chunk costs at most one decode tick of stage time,
        shrunk further on a bandwidth-capped deployment so that one
        chunk's wire time also fits a stage tick
        (``serving.engine.prefill_chunk_cap``).  ``bandwidth=0`` is the
        paper's PCIe rate.

        ``deployment`` — a :class:`repro_torch.distributed.transport
        .DeploymentPlan` (e.g. from ``framework.registry.match``):
        supplies ``n_stages`` (its stage count), ``latency`` (its **max
        ring-link latency** — the slowest link sets the §4.3 bubble
        budget) plus the per-link ``link_latencies`` the planner consumes,
        the worst ``LinkSpec`` that caps the prefill chunk, and, on the
        pipelined backend, a per-link ``SimulatedLinkTransport`` unless an
        explicit ``transport`` is given."""
        link_latencies = worst_link = None
        if deployment is not None:
            if n_stages is None:
                n_stages = deployment.n_stages
            if latency is None:
                latency = deployment.max_link_latency
            if transport is None and backend == "pipelined":
                transport = deployment.transport()
            link_latencies = list(deployment.link_latencies)
            worst_link = deployment.worst_link
        if n_stages is None or latency is None:
            raise ValueError("EngineConfig.plan needs n_stages= and "
                             "latency= (or a deployment= plan supplying "
                             "both)")
        return cls(backend=backend, n_stages=n_stages, mesh=mesh, seed=seed,
                   prefill_chunk=prefill_chunk,
                   max_prefill_tokens_per_tick=max_prefill_tokens_per_tick,
                   prefill_mode=prefill_mode, offload_async=offload_async,
                   transport=transport, schedule=schedule,
                   wire_dtype=wire_dtype, fault_plan=fault_plan,
                   prefix_cache=prefix_cache, slo=slo, trace=trace,
                   strict=strict,
                   plan_args=dict(
                       n_stages=n_stages, stage_time=stage_time,
                       latency=latency, link_latencies=link_latencies,
                       worst_link=worst_link, m_kv_bytes=m_kv_bytes,
                       page_size=page_size,
                       max_pages_per_seq=max_pages_per_seq,
                       bandwidth=bandwidth, use_offload=use_offload,
                       max_microbatches=max_microbatches, choice=choice,
                       mb_size_cap=mb_size_cap))

    def build(self, cfg: ModelConfig, params: dict, rt: Runtime,
              device=None) -> OfflineEngine:
        if self.plan_args is not None:
            return OfflineEngine.from_plan(
                cfg, params, rt, seed=self.seed,
                prefill_chunk=self.prefill_chunk,
                max_prefill_tokens_per_tick=self.max_prefill_tokens_per_tick,
                prefill_mode=self.prefill_mode,
                offload_async=self.offload_async, backend=self.backend,
                mesh=self.mesh, transport=self.transport,
                schedule=self.schedule, wire_dtype=self.wire_dtype,
                fault_plan=self.fault_plan, prefix_cache=self.prefix_cache,
                slo=self.slo, device=device, trace=self.trace,
                strict=self.strict, **self.plan_args)
        pool = self.pool or PoolConfig()
        offloader = None
        if self.offload and pool.n_global_pages:
            offloader = DoubleBufferOffloader(pool, self.num_microbatches,
                                              async_swap=self.offload_async)
        return OfflineEngine(
            cfg, params, rt, mb_size=self.mb_size,
            num_microbatches=self.num_microbatches, pool=pool,
            offloader=offloader, seed=self.seed, backend=self.backend,
            n_stages=self.n_stages, mesh=self.mesh,
            prefill_chunk=self.prefill_chunk,
            max_prefill_tokens_per_tick=self.max_prefill_tokens_per_tick,
            prefill_mode=self.prefill_mode, transport=self.transport,
            schedule=self.schedule, wire_dtype=self.wire_dtype,
            fault_plan=self.fault_plan, prefix_cache=self.prefix_cache,
            slo=self.slo, device=device, trace=self.trace,
            strict=self.strict)


@dataclass
class RequestOutput:
    """What a caller gets back for one request — no engine internals."""
    request_id: int
    prompt: List[int]
    token_ids: List[int]
    finished: bool
    finish_reason: Optional[str]      # "eos" | "length" | "page_budget"
    status: str
    logprobs: Optional[List[float]] = None
    latency_steps: Optional[int] = None
    latency_s: Optional[float] = None
    ttft_s: Optional[float] = None
    # per-request flight-recorder snapshot (EngineConfig(trace=...) on):
    # queue_wait_s / ttft_s / inter_token_s, chunks, pages,
    # prefix_hit_tokens — None when tracing is off
    trace: Optional[dict] = None

    @classmethod
    def from_seq(cls, seq: SequenceState,
                 trace: Optional[dict] = None) -> "RequestOutput":
        reason = seq.finish_reason()
        done = seq.status is Status.FINISHED
        return cls(
            request_id=seq.request.request_id,
            prompt=list(seq.request.prompt),
            token_ids=list(seq.generated),
            finished=done,
            finish_reason=reason.value if reason is not None and done
            else None,
            status=seq.status.value,
            logprobs=list(seq.logprobs) if seq.logprobs is not None else None,
            latency_steps=seq.latency_steps,
            latency_s=seq.latency_s,
            ttft_s=seq.ttft_s,
            trace=trace)


class LLM:
    """Front door for offline generation.

    ``model`` is an arch name (``"yi-9b"``) or a :class:`ModelConfig`.  By
    default the registered arch is shrunk with ``reduced_config`` and the
    weights are random from ``config.seed``; pass ``reduced=False`` and/or
    ``params=`` for real deployments.  ``device`` defaults to ``cuda``."""

    def __init__(self, model: Union[str, ModelConfig], *,
                 config: Optional[EngineConfig] = None,
                 params: Optional[dict] = None, rt: Optional[Runtime] = None,
                 reduced: bool = True, device=None):
        cfg = get_arch(model) if isinstance(model, str) else model
        if reduced and isinstance(model, str):
            cfg = reduced_config(cfg)
        self.config = config or EngineConfig()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rt = rt or Runtime(param_dtype=torch.float32,
                                compute_dtype=torch.float32)
        if params is None:
            # with a mesh the weights are drawn placed by stage, so no card
            # ever holds more than its share and one layer
            conf = self.config
            layer_devices = None if conf.mesh is None else \
                PL.layer_devices(cfg, stage_devices(conf.mesh, conf.n_stages,
                                                    self.device))
            params = model_lib.init_params(cfg, conf.seed, self.rt,
                                           self.device,
                                           layer_devices=layer_devices)
        self.params = params
        self.engine = self.config.build(cfg, params, self.rt, self.device)
        self._next_id = 0

    def _make_requests(self, prompts: Sequence[Sequence[int]],
                       sampling_params) -> List[Request]:
        if sampling_params is None:
            sampling_params = self.engine.default_sampling
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params] * len(prompts)
        if len(sampling_params) != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts but "
                             f"{len(sampling_params)} sampling_params")
        reqs = []
        for p, sp in zip(prompts, sampling_params):
            reqs.append(Request(self._next_id, [int(t) for t in p],
                                dataclasses.replace(sp)))
            self._next_id += 1
        return reqs

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling_params: Union[SamplingParams,
                                        Sequence[SamplingParams],
                                        None] = None, *,
                 max_steps: int = 100_000) -> List[RequestOutput]:
        """Generate to completion for every prompt; one
        :class:`RequestOutput` per prompt, in prompt order."""
        seqs = self.engine.submit(self._make_requests(prompts,
                                                      sampling_params))
        self.engine.run(max_steps=max_steps)
        return [RequestOutput.from_seq(
            s, trace=self.engine.request_trace(s.request.request_id))
            for s in seqs]

    def stats(self) -> Dict:
        return self.engine.throughput_report()
