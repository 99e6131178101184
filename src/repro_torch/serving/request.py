"""Request/sequence bookkeeping for the offline serving engine (own copy of
``repro.serving.request``; host-side Python, no tensors)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


class FinishReason(enum.Enum):
    EOS = "eos"                       # emitted the request's eos token
    LENGTH = "length"                 # hit sampling.max_new_tokens
    PAGE_BUDGET = "page_budget"       # hit the per-sequence page capacity


@dataclass
class SamplingParams:
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = no top-k
    top_p: float = 1.0
    max_new_tokens: int = 64
    eos_token: int = -1               # -1 = never terminate early
    logprobs: bool = False            # record per-token logprobs

    def validate(self) -> "SamplingParams":
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        return self


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    # None = use the engine's default sampling (resolved at submit())
    sampling: Optional[SamplingParams] = None


@dataclass
class SequenceState:
    request: Request
    # the request's effective SamplingParams, resolved at submit() onto a
    # private copy — the caller's Request object is never written back
    sampling: Optional[SamplingParams] = None
    status: Status = Status.QUEUED
    slot: int = -1                    # decode-batch slot, -1 = unassigned
    generated: List[int] = field(default_factory=list)
    budget: Optional[int] = None      # engine-side cap (page capacity)
    logprobs: Optional[List[float]] = None    # per generated token, if asked
    # chunked prefill: prompt tokens already written into the KV cache and
    # whether a chunk for this sequence is currently in flight
    prefill_pos: int = 0
    chunk_inflight: bool = False
    global_parity: Optional[int] = None       # global-pool parity of the
                                              # slot's pages (None=all-local)
    submit_step: int = -1
    finish_step: int = -1
    submit_time: float = 0.0
    finish_time: float = 0.0
    first_token_time: float = 0.0

    def __post_init__(self) -> None:
        if self.sampling is None:
            self.sampling = self.request.sampling

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    def _cap(self) -> int:
        sp = self.sampling
        return sp.max_new_tokens if self.budget is None else \
            min(sp.max_new_tokens, self.budget)

    def is_done(self) -> bool:
        if len(self.generated) >= self._cap():
            return True
        return bool(self.generated) and \
            self.generated[-1] == self.sampling.eos_token

    def finish_reason(self) -> Optional[FinishReason]:
        """Why the sequence stopped (None while still in flight)."""
        if not self.is_done():
            return None
        sp = self.sampling
        if self.generated and self.generated[-1] == sp.eos_token:
            return FinishReason.EOS
        if self.budget is not None and self.budget < sp.max_new_tokens \
                and len(self.generated) >= self.budget:
            return FinishReason.PAGE_BUDGET
        return FinishReason.LENGTH

    @property
    def latency_steps(self) -> Optional[int]:
        if self.finish_step < 0 or self.submit_step < 0:
            return None
        return self.finish_step - self.submit_step

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_step < 0 or self.submit_step < 0:
            return None
        return self.finish_time - self.submit_time

    @property
    def ttft_s(self) -> Optional[float]:
        """Engine-side time-to-first-token (None until sampled)."""
        if self.first_token_time <= 0.0 or self.submit_time <= 0.0:
            return None
        return self.first_token_time - self.submit_time


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    finished_requests: int = 0
    steps: int = 0
    swaps: int = 0                    # global-pool swaps (offloader)
    wall_time_s: float = 0.0          # accumulated inside step()
    # wall_time_s split by phase: prefill covers admission + chunk work,
    # decode covers the microbatch tick (+ reap)
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    queue_depth: int = 0              # requests waiting (refreshed per step)
    status_counts: Dict[str, int] = field(default_factory=dict)
    aborted: bool = False             # run() exhausted max_steps with
                                      # work still pending

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_time_s if self.decode_time_s \
            else 0.0

    @property
    def prefill_tok_per_s(self) -> float:
        return self.prefill_tokens / self.prefill_time_s \
            if self.prefill_time_s else 0.0
