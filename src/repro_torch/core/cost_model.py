"""DeServe §3 cost/profit model (Tables 1 and 2); own copy of
``repro.core.cost_model`` without its TPU platform row.

The unit of account is one "compute resource unit" — an 8-GPU pipeline
serving the target model.  Profitability:  R > C·T  ⇔  M > C / P
with throughput M (tok/s), per-hour cost C, and unified per-token price P.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

# Together.ai Llama-70B price used by the paper (USD per 1M tokens)
DEFAULT_PRICE_PER_MTOK = 0.90


@dataclass(frozen=True)
class ComputePlatform:
    name: str
    spec: str
    cost_per_hour: float          # USD, 8-GPU equivalent
    latency_class: str            # low | medium | high
    gpu_type: str
    availability: str


# Table 1 / Table 2 rows (paper values, accessed 2024-10-31)
PLATFORMS: Dict[str, ComputePlatform] = {
    "cloud": ComputePlatform(
        "cloud", "GCP-8x g2-standard-32 (L4)", 13.88, "low",
        "standardized", "99.9%+ uptime"),
    "runpod": ComputePlatform(
        "runpod", "RunPod-8x4090", 5.52, "medium",
        "heterogeneous", "variable uptime"),
    "ionet": ComputePlatform(
        "ionet", "io.net-8x4090", 3.69, "medium",
        "heterogeneous", "variable uptime"),
    "mining": ComputePlatform(
        "mining", "WhatToMine-8x4090", 0.35, "high",
        "heterogeneous", "intermittent"),
}


def min_throughput(cost_per_hour: float,
                   price_per_mtok: float = DEFAULT_PRICE_PER_MTOK) -> float:
    """Break-even total throughput in tokens/second:  M_min = C / P."""
    price_per_token = price_per_mtok / 1e6
    return cost_per_hour / 3600.0 / price_per_token


def profit_per_hour(throughput_tps: float, cost_per_hour: float,
                    price_per_mtok: float = DEFAULT_PRICE_PER_MTOK) -> float:
    revenue = throughput_tps * 3600.0 * price_per_mtok / 1e6
    return revenue - cost_per_hour


def is_profitable(throughput_tps: float, platform: str,
                  price_per_mtok: float = DEFAULT_PRICE_PER_MTOK) -> bool:
    return profit_per_hour(throughput_tps, PLATFORMS[platform].cost_per_hour,
                           price_per_mtok) > 0


def table2(price_per_mtok: float = DEFAULT_PRICE_PER_MTOK) -> Dict[str, dict]:
    """Reproduce paper Table 2."""
    return {
        name: {
            "spec": p.spec,
            "cost_per_hour": p.cost_per_hour,
            "price_per_mtok": price_per_mtok,
            "min_throughput_tps": min_throughput(p.cost_per_hour,
                                                 price_per_mtok),
        }
        for name, p in PLATFORMS.items()
    }


# Paper Table 2 reference values for validation (tokens/second)
PAPER_TABLE2 = {
    "cloud": 4283.33,
    "runpod": 1703.70,
    "ionet": 1138.89,
    "mining": 108.02,
}
