"""Reduce a ``torch.profiler`` Chrome trace to the device's timeline.

Kept: every device operation (kernels, copies, sets; ``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset``) with its card, and the harness's own host
spans (``bench.*`` ``user_annotation`` ranges: ``bench.traced`` around
the slice, ``bench.step``, ``bench.decode``, ``bench.prefill``,
``bench.harness``).  Times are in seconds on the trace's clock, on which
the profiler lays host and device events alike.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's spans, innermost first (those of one name never overlap)
INNER_FIRST = ("bench.decode", "bench.prefill", "bench.harness",
               "bench.step")


@dataclass
class Timeline:
    ops: Dict[int, List[Tuple[float, float, str]]] = field(
        default_factory=dict)               # card -> (start, end, name)
    spans: List[Tuple[float, float, str]] = field(default_factory=list)
    t0: float = 0.0                         # the traced slice
    t1: float = 0.0
    _by_name: Optional[dict] = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def cards(self) -> List[int]:
        return sorted(self.ops)

    def busy_intervals(self, card: int) -> List[Tuple[float, float]]:
        """The union of the card's operations, clipped to the slice."""
        out: List[list] = []
        for s, e, _ in sorted(self.ops.get(card, ())):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self, card: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(card))

    def mean_busy_s(self, n_cards: int) -> float:
        """Busy seconds averaged over ``n_cards`` cards (a card with no
        operation counts as idle)."""
        return sum(self.busy_s(c) for c in self.cards()) / max(1, n_cards)

    def op_seconds(self) -> Dict[str, float]:
        """Seconds by operation name, over every card, inside the slice."""
        out: Dict[str, float] = defaultdict(float)
        for ops in self.ops.values():
            for s, e, name in ops:
                if s >= self.t0 and e <= self.t1:
                    out[name] += e - s
        return dict(out)

    def ops_named(self, part: str) -> List[Tuple[float, float, str]]:
        return [op for ops in self.ops.values() for op in ops
                if part in op[2] and op[0] >= self.t0 and op[1] <= self.t1]

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        return [(s, e) for s, e, n in self.spans if n == name]

    def device_s_within(self, spans: List[Tuple[float, float]]) -> float:
        """Device seconds of the operations that start inside the spans."""
        starts = sorted((s, e) for ops in self.ops.values()
                        for s, e, _ in ops)
        total, i = 0.0, 0
        for lo, hi in sorted(spans):
            while i < len(starts) and starts[i][0] < lo:
                i += 1
            j = i
            while j < len(starts) and starts[j][0] <= hi:
                total += starts[j][1] - starts[j][0]
                j += 1
        return total

    def idle_gaps(self, card: int) -> List[Tuple[float, float]]:
        gaps, t = [], self.t0
        for s, e in self.busy_intervals(card):
            if s > t:
                gaps.append((t, s))
            t = e
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost harness span running on the host at ``t``."""
        if self._by_name is None:
            self._by_name = {}
            for s, e, name in sorted(self.spans):
                starts, ends = self._by_name.setdefault(name, ([], []))
                starts.append(s)
                ends.append(e)
        for name in INNER_FIRST:
            starts, ends = self._by_name.get(name, ((), ()))
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                return name
        return "none"


def read(path: str) -> Timeline:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    tl = Timeline()
    ops: Dict[int, list] = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            args = ev.get("args", {})
            card = int(args.get("device", ev.get("pid", 0)))
            ops[card].append((s, e, ev.get("name", "?")))
        elif cat == "user_annotation" and \
                str(ev.get("name", "")).startswith("bench."):
            tl.spans.append((s, e, ev["name"]))
    tl.ops = dict(ops)
    traced = [(s, e) for s, e, n in tl.spans if n == "bench.traced"]
    if traced:
        tl.t0, tl.t1 = traced[0]
    elif tl.spans:
        tl.t0 = min(s for s, _, _ in tl.spans)
        tl.t1 = max(e for _, e, _ in tl.spans)
    return tl


def breakdown(tl: Timeline, n_cards: int, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle
    seconds by what the host was doing, averaged over the cards."""
    ops = sorted(tl.op_seconds().items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = defaultdict(float)
    for card in range(n_cards):
        for s, e in tl.idle_gaps(card) if card in tl.ops else \
                [(tl.t0, tl.t1)]:
            idle[tl.host_at(0.5 * (s + e))] += (e - s) / n_cards
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
