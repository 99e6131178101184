"""Counter/gauge/histogram registry with snapshot deltas and
Prometheus-text / JSONL exposition (own copy of ``repro.obs.metrics``).

:class:`Metrics` is a plain host-side registry — no background threads,
no device access.  ``update_from_engine`` maps the engine's own report
onto it: ``EngineStats`` fields become counters/gauges, the transport
books become gauges, and the per-stage ``StragglerMitigator``
observations (exposed by ``OfflineEngine.throughput_report()["stages"]``)
become per-stage labelled gauges.  Snapshots are cheap dicts, so a
serve loop can diff two of them (``Metrics.delta``) to get a per-window
rate report without resetting anything.

Exposition formats:

* :meth:`Metrics.prometheus_text` — the Prometheus text format
  (``# TYPE`` headers, ``name{label="v"} value`` samples, histogram
  ``_bucket``/``_sum``/``_count`` triplets) for scrape endpoints.
* :meth:`Metrics.jsonl_line` — one JSON object per call (flat
  ``{name: value}`` plus a wall stamp) for append-only log files.
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Metrics", "Counter", "Gauge", "Histogram",
           "update_from_engine"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# default histogram buckets: exponential seconds, serving-latency shaped
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotone accumulator.  ``inc`` with a negative amount raises —
    a counter that goes backward is a books bug, not a metric."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})")
        self.value += amount

    def set_to(self, value: float) -> None:
        """Advance to an externally-maintained monotone total (the
        engine keeps its own books; the metric mirrors them)."""
        if value < self.value:
            raise ValueError(
                f"counter {self.name} moved backward: "
                f"{self.value} -> {value}")
        self.value = value


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs >= 1 bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class Metrics:
    """The registry.  Metric identity is ``(name, labels)`` where labels
    is a tuple of ``(key, value)`` pairs; re-registering an existing
    identity returns the existing instrument (idempotent wiring)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    # -- registration -----------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, str], help: str,
             **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help=help, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name} already registered as "
                             f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels or {}, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels or {}, help)

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, labels or {}, help,
                         buckets=buckets)

    # -- snapshots --------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name{labels}: value}`` — histograms contribute their
        ``_sum`` and ``_count`` series."""
        out: Dict[str, float] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            tag = _sanitize(name) + _fmt_labels(labels)
            if isinstance(m, Histogram):
                out[tag + "_sum"] = m.sum
                out[tag + "_count"] = float(m.count)
            else:
                out[tag] = m.value
        return out

    @staticmethod
    def delta(prev: Dict[str, float],
              cur: Dict[str, float]) -> Dict[str, float]:
        """Per-key change between two snapshots (keys only in ``cur``
        count from zero) — the per-window rate numerator."""
        return {k: v - prev.get(k, 0.0) for k, v in cur.items()}

    # -- exposition -------------------------------------------------------

    def prometheus_text(self) -> str:
        lines: List[str] = []
        seen_type = set()
        for (name, labels), m in sorted(self._metrics.items()):
            sname = _sanitize(name)
            if sname not in seen_type:
                seen_type.add(sname)
                if m.help:
                    lines.append(f"# HELP {sname} {m.help}")
                lines.append(f"# TYPE {sname} {m.kind}")
            tag = _fmt_labels(labels)
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.buckets, m.counts):
                    cum += c
                    lb = dict(labels)
                    lb["le"] = repr(float(b))
                    lines.append(f"{sname}_bucket"
                                 f"{_fmt_labels(tuple(sorted(lb.items())))}"
                                 f" {cum}")
                lb = dict(labels)
                lb["le"] = "+Inf"
                lines.append(f"{sname}_bucket"
                             f"{_fmt_labels(tuple(sorted(lb.items())))}"
                             f" {m.count}")
                lines.append(f"{sname}_sum{tag} {m.sum}")
                lines.append(f"{sname}_count{tag} {m.count}")
            else:
                lines.append(f"{sname}{tag} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def jsonl_line(self) -> str:
        snap = self.snapshot()
        snap["_ts"] = time.time()
        return json.dumps(snap, sort_keys=True)


# ---------------------------------------------------------------------------
# Engine mapping
# ---------------------------------------------------------------------------


def update_from_engine(metrics: Metrics, engine) -> Dict[str, float]:
    """Map one engine report onto the registry and return the snapshot.

    Uses ``engine.throughput_report()`` — which (by contract, see
    ``EngineStats.status_counts``) refreshes the status counts — so a
    metrics scrape can never observe stale queue/decode occupancy.
    """
    rep = engine.throughput_report()
    for name, key in (("repro_tokens_total", "total_tokens"),
                      ("repro_decode_tokens_total", "decode_tokens"),
                      ("repro_prefill_tokens_total", "prefill_tokens"),
                      ("repro_requests_finished_total", "finished"),
                      ("repro_engine_steps_total", "steps"),
                      ("repro_offload_swaps_total", "swaps"),
                      ("repro_prefix_hits_total", "prefix_hits"),
                      ("repro_prefix_hit_tokens_total",
                       "prefix_hit_tokens")):
        if key in rep:
            metrics.counter(name).set_to(float(rep[key]))
    for name, key in (("repro_tok_per_s", "tok_per_s"),
                      ("repro_decode_tok_per_s", "decode_tok_per_s"),
                      ("repro_prefill_tok_per_s", "prefill_tok_per_s"),
                      ("repro_wall_time_s", "wall_time_s"),
                      ("repro_queue_depth", "queue_depth"),
                      ("repro_mean_latency_steps", "mean_latency_steps")):
        if key in rep:
            metrics.gauge(name).set(float(rep[key]))
    for status, n in (rep.get("status_counts") or {}).items():
        metrics.gauge("repro_requests",
                      labels={"status": str(status)}).set(float(n))
    for key, v in (rep.get("transport") or {}).items():
        if isinstance(v, (int, float)):
            metrics.gauge(f"repro_transport_{key}").set(float(v))
    stages = rep.get("stages") or {}
    for s, t in enumerate(stages.get("ewma_s", ())):
        metrics.gauge("repro_stage_time_ewma_s",
                      labels={"stage": str(s)}).set(float(t))
    for s, t in enumerate(stages.get("total_s", ())):
        metrics.gauge("repro_stage_time_total_s",
                      labels={"stage": str(s)}).set(float(t))
    for s, w in enumerate(stages.get("microbatch_weights", ())):
        metrics.gauge("repro_stage_admission_weight",
                      labels={"stage": str(s)}).set(float(w))
    stragglers = set(stages.get("stragglers", ()))
    for s in range(len(stages.get("ewma_s", ()))):
        metrics.gauge("repro_stage_straggler",
                      labels={"stage": str(s)}).set(
                          1.0 if s in stragglers else 0.0)
    return metrics.snapshot()
