"""Microbatch scheduling (DeServe §4.3): fill network-latency bubbles (own
copy of ``repro.core.scheduler``; the offload bandwidth defaults to the
paper's PCIe figure).

With ``N_M`` pipeline stages of compute time ``T_S`` each and one-way link
latency ``L``, a microbatch's round-trip through the ring takes
``N_M · (T_S + L)``.  A stage is bubble-free iff a new microbatch arrives
every ``T_S``, i.e. iff

      N_B* = ceil( N_M · (T_S + L) / T_S )

microbatches are in flight (paper Figure 2(c): N_M=4, L=T_S/2 → N_B*=6).
The scheduler also composes the per-microbatch batch under the Formula-1
capacity, and emits the steady-state (tick, stage) → microbatch timetable
the simulator and the SPMD pipeline share.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core import offload as offload_lib


def _lat_sum(n_stages: int, latency: float,
             link_latencies: Optional[Sequence[float]]) -> float:
    """Total one-way link latency around the ring.

    The per-link generalisation of the §4.3 formulas: a microbatch's
    round trip is ``n_stages·T_S + Σ L_i`` — only the *sum* of the ring
    latencies enters the steady state (the ``PipelineSimulator``'s
    circular round time uses exactly this) — which collapses to
    ``n_stages·(T_S+L)`` on a uniform ring.  ``link_latencies`` wins
    when both are given (the scalar stays as the display/back-compat
    argument)."""
    if link_latencies is not None:
        lats = [float(l) for l in link_latencies]
        if len(lats) != n_stages:
            raise ValueError(
                f"link_latencies has {len(lats)} entries but the ring has "
                f"{n_stages} stage(s) — one link per stage")
        if any(l < 0 for l in lats):
            raise ValueError(f"link latencies must be >= 0, got {lats}")
        return sum(lats)
    return n_stages * latency


def optimal_microbatches(n_stages: int, stage_time: float,
                         latency: float = 0.0, *,
                         link_latencies: Optional[Sequence[float]] = None
                         ) -> int:
    """N_B* — the bubble-free in-flight microbatch count (paper §4.3).

    Per-link form: ``ceil((N_M·T_S + Σ L_i) / T_S)``; the uniform-ring
    scalar ``latency`` reproduces the paper's ``N_M·(T_S+L)/T_S``."""
    if stage_time <= 0:
        return n_stages
    trip = n_stages * stage_time + _lat_sum(n_stages, latency,
                                            link_latencies)
    return max(n_stages, math.ceil(trip / stage_time))


def bubble_fraction(n_stages: int, n_microbatches: int, stage_time: float,
                    latency: float = 0.0, *,
                    link_latencies: Optional[Sequence[float]] = None
                    ) -> float:
    """Fraction of each stage's steady-state time spent idle.

    A microbatch returns to a stage after ``N_M·T_S + Σ L_i``; the stage
    does useful work for ``N_B·T_S`` of that (capped at 1.0)."""
    period = n_stages * stage_time + _lat_sum(n_stages, latency,
                                              link_latencies)
    busy = min(n_microbatches * stage_time, period)
    return max(0.0, 1.0 - busy / period)


@dataclass(frozen=True)
class PipelineSchedule:
    n_stages: int
    n_microbatches: int
    stage_time: float
    latency: float

    @property
    def round_trip(self) -> float:
        return self.n_stages * (self.stage_time + self.latency)

    @property
    def steady_tick(self) -> float:
        """Wall time between consecutive ticks of one stage in steady state:
        max of compute-bound (T_S) and latency-bound (round-trip / N_B)."""
        return max(self.stage_time, self.round_trip / self.n_microbatches)

    def microbatch_at(self, stage: int, tick: int) -> int:
        """Steady-state circular schedule: stage s processes microbatch
        (tick - s) mod N_B at tick ``tick``."""
        return (tick - stage) % self.n_microbatches

    def utilisation(self) -> float:
        return 1.0 - bubble_fraction(self.n_stages, self.n_microbatches,
                                     self.stage_time, self.latency)


@dataclass
class ScheduleChoice:
    """Output of the planner: how many microbatches, how large each batch."""
    n_microbatches: int
    per_mb_batch: int
    per_mb_kv_bytes: float
    utilisation: float
    offload: bool

    @property
    def total_batch(self) -> int:
        return self.n_microbatches * self.per_mb_batch


def plan_schedule(*, n_stages: int, stage_time: float, latency: float = 0.0,
                  link_latencies: Optional[Sequence[float]] = None,
                  m_kv_bytes: float, kv_bytes_per_seq: float,
                  offload_bandwidth: float = offload_lib.PCIE4_BW,
                  use_offload: bool = True,
                  host_kv_bytes: float = float("inf"),
                  max_microbatches: int = 64) -> ScheduleChoice:
    """Choose (N_B, per-microbatch batch) maximising steady-state throughput.

    Steady-state output rate is  N_B·b / max(N_B·T_S, N_M·T_S + Σ L_i) —
    flat in N_B once the pipe is bubble-free, so the planner picks the
    *smallest* N_B attaining the maximum (less host memory, less in-flight
    state).  ``link_latencies`` is the per-link generalisation (a real
    deployment's heterogeneous ring — ``DeploymentPlan.link_latencies``
    plugs straight in); the scalar ``latency`` is the uniform-ring
    shorthand ``Σ L_i = N_M·L``.  Without offload, raising N_B shrinks
    per-mb capacity (wash at best); with offload the M_G floor keeps
    per-mb batch up while N_B covers the latency — the paper's central
    synergy.  ``host_kv_bytes`` bounds the total offloaded footprint
    N_B·M_B'.
    """
    best: Optional[ScheduleChoice] = None
    best_rate = -1.0
    lat_sum = _lat_sum(n_stages, latency, link_latencies)
    n_star = optimal_microbatches(n_stages, stage_time, latency,
                                  link_latencies=link_latencies)
    # search a little past N_B* but never past the hard cap: the caller's
    # host memory / pipe depth bound wins over the bubble-free optimum
    if max_microbatches < n_stages:
        raise ValueError(
            f"max_microbatches={max_microbatches} < n_stages={n_stages}: "
            "the circular schedule needs at least one microbatch per stage")
    hi = min(max(n_star + 2, n_stages), max_microbatches)
    for n_b in range(n_stages, hi + 1):
        if use_offload:
            m_g = min(offload_lib.global_pool_bytes(offload_bandwidth,
                                                    stage_time),
                      m_kv_bytes / 2.0)
            cap = offload_lib.per_microbatch_capacity(m_kv_bytes, m_g, n_b)
        else:
            cap = offload_lib.per_microbatch_capacity_no_offload(
                m_kv_bytes, n_b)
        if n_b * cap > host_kv_bytes + m_kv_bytes:
            continue
        bsz = offload_lib.batch_size_from_capacity(cap, kv_bytes_per_seq)
        if bsz == 0:
            continue
        util = 1.0 - bubble_fraction(n_stages, n_b, stage_time, latency,
                                     link_latencies=link_latencies)
        rate = (n_b * bsz) / max(n_b * stage_time,
                                 n_stages * stage_time + lat_sum)
        if rate > best_rate * (1.0 + 1e-9):
            best_rate = rate
            best = ScheduleChoice(n_microbatches=n_b, per_mb_batch=bsz,
                                  per_mb_kv_bytes=cap, utilisation=util,
                                  offload=use_offload)
    if best is None:
        raise ValueError("no feasible schedule: one sequence's KV exceeds "
                         "per-microbatch capacity")
    return best


def schedule_diagram(n_stages: int, n_microbatches: int, *,
                     stage_time: float = 1.0, latency: float = 0.0,
                     ticks: int = 0) -> str:
    """ASCII rendering of the circular schedule (paper Figure 2).

    Each cell is the microbatch a stage processes at that tick; '.' is a
    bubble (fill/drain or latency-starved).  With the N_B* count the steady
    state shows no '.' columns — the paper's Figure 2(c).
    """
    ticks = ticks or (2 * n_microbatches + n_stages)
    need = optimal_microbatches(n_stages, stage_time, latency)
    lines = [f"stages={n_stages} N_B={n_microbatches} "
             f"(bubble-free needs N_B*={need})"]
    for s in range(n_stages):
        row = []
        for t in range(ticks):
            m = t - s
            if m < 0:
                row.append(" .")
            elif n_microbatches >= need:
                row.append(f"{m % n_microbatches:2d}")
            else:
                # latency-starved: stage idles between rounds
                phase = m % need
                row.append(f"{phase:2d}" if phase < n_microbatches else " .")
        lines.append(f"  stage{s} |" + "".join(row))
    return "\n".join(lines)
