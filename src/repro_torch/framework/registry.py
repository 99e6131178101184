"""Task & GPU registries (paper §6.2, Figure 1) — protocol-faithful local
implementation of the on-chain service-discovery components (own copy of
``repro.framework.registry``, which the port may not import).

Users register offline inference tasks (workload + escrowed budget); miners
register machines (GPU memory, region, stake).  ``match`` builds serving
pipelines: it selects a set of machines whose pooled memory fits the model
(inter-layer partitioning, §2.3) while minimising the maximum pairwise
latency inside the pipeline (latency sets the bubble budget, §4.3).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TaskSpec:
    task_id: int
    owner: str
    model_name: str
    model_bytes: int                  # weights footprint
    n_requests: int
    max_price_per_mtok: float
    deadline_hours: float = 24.0
    status: str = "open"              # open | matched | done | disputed


@dataclass
class MachineSpec:
    machine_id: int
    miner: str
    gpu_memory_bytes: int
    region: str
    stake: float
    status: str = "idle"              # idle | serving | offline

    def usable_memory(self, weight_fraction: float = 0.8) -> int:
        return int(self.gpu_memory_bytes * weight_fraction)


# symmetric inter-region one-way latencies (seconds)
REGION_LATENCY = {
    ("us-east", "us-east"): 0.002,
    ("us-east", "us-west"): 0.058,
    ("us-east", "eu"): 0.090,
    ("us-west", "us-west"): 0.002,
    ("us-west", "eu"): 0.140,
    ("eu", "eu"): 0.002,
}


def region_latency(a: str, b: str) -> float:
    return REGION_LATENCY.get((a, b), REGION_LATENCY.get((b, a), 0.2))


@dataclass
class Match:
    task: TaskSpec
    machines: List[MachineSpec]
    max_latency: float

    @property
    def n_stages(self) -> int:
        return len(self.machines)


class Registry:
    def __init__(self):
        self.tasks: Dict[int, TaskSpec] = {}
        self.machines: Dict[int, MachineSpec] = {}
        self._next_task = 0
        self._next_machine = 0

    # -- registration ---------------------------------------------------

    def register_task(self, owner: str, model_name: str, model_bytes: int,
                      n_requests: int, max_price: float) -> TaskSpec:
        t = TaskSpec(task_id=self._next_task, owner=owner,
                     model_name=model_name, model_bytes=model_bytes,
                     n_requests=n_requests, max_price_per_mtok=max_price)
        self.tasks[t.task_id] = t
        self._next_task += 1
        return t

    def register_machine(self, miner: str, gpu_memory_bytes: int,
                         region: str, stake: float) -> MachineSpec:
        m = MachineSpec(machine_id=self._next_machine, miner=miner,
                        gpu_memory_bytes=gpu_memory_bytes, region=region,
                        stake=stake)
        self.machines[m.machine_id] = m
        self._next_machine += 1
        return m

    # -- matching ---------------------------------------------------------

    # past this many distinct regions, exact region-subset enumeration
    # (2^R) gives way to the greedy heuristic
    EXACT_REGION_LIMIT = 12

    @staticmethod
    def _group_latency(group: List[MachineSpec]) -> float:
        return max((region_latency(a.region, b.region)
                    for a, b in itertools.combinations(group, 2)),
                   default=region_latency(group[0].region,
                                          group[0].region))

    def match(self, task_id: int, *, min_stake: float = 0.0) -> Optional[Match]:
        """Machine set with pooled memory >= model_bytes that *minimises*
        the maximum pairwise latency inside the pipeline (§4.3: the
        slowest link sets the bubble budget), tie-broken by fewer
        machines.

        A machine set's max pairwise latency is a function of the set of
        regions it spans, so enumerating region subsets in latency order
        and checking feasibility (pooled idle memory of those regions)
        is exact: the first feasible subset is optimal.  Within the
        winning subset the machines are taken largest-memory-first, so
        the pipeline is also the shortest one that region choice admits.
        Beyond :attr:`EXACT_REGION_LIMIT` distinct regions the old greedy
        heuristic (per-region prefixes + global memory-greedy prefix)
        bounds the work.
        """
        task = self.tasks[task_id]
        idle = [m for m in self.machines.values()
                if m.status == "idle" and m.stake >= min_stake]
        if not idle:
            return None
        by_region: Dict[str, List[MachineSpec]] = {}
        for m in idle:
            by_region.setdefault(m.region, []).append(m)
        regions = sorted(by_region)

        candidates: List[List[MachineSpec]] = []
        if len(regions) <= self.EXACT_REGION_LIMIT:
            for ms in by_region.values():       # sort each region once;
                ms.sort(key=lambda m: -m.gpu_memory_bytes)  # combos merge
            for r in range(1, len(regions) + 1):
                for combo in itertools.combinations(regions, r):
                    ms = heapq.merge(*(by_region[reg] for reg in combo),
                                     key=lambda m: -m.gpu_memory_bytes)
                    chosen, total = [], 0
                    for m in ms:
                        chosen.append(m)
                        total += m.usable_memory()
                        if total >= task.model_bytes:
                            candidates.append(chosen)
                            break
        else:                                   # heuristic fallback
            for region, ms in by_region.items():
                ms = sorted(ms, key=lambda m: -m.gpu_memory_bytes)
                for k in range(1, len(ms) + 1):
                    if sum(m.usable_memory()
                           for m in ms[:k]) >= task.model_bytes:
                        candidates.append(ms[:k])
                        break
            all_ms = sorted(idle, key=lambda m: -m.gpu_memory_bytes)
            for k in range(1, len(all_ms) + 1):
                if sum(m.usable_memory()
                       for m in all_ms[:k]) >= task.model_bytes:
                    candidates.append(all_ms[:k])
                    break

        best: Optional[Match] = None
        for group in candidates:
            lat = self._group_latency(group)
            cand = Match(task=task, machines=group, max_latency=lat)
            if best is None or (lat, len(group)) < (best.max_latency,
                                                    best.n_stages):
                best = cand
        if best is not None:
            task.status = "matched"
            for m in best.machines:
                m.status = "serving"
        return best

    def release(self, match: Match, *, done: bool = True) -> None:
        match.task.status = "done" if done else "open"
        for m in match.machines:
            m.status = "idle"
