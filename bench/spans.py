"""The program's own spans beside the device's timeline.

``repro_torch``'s flight recorder (``repro_torch.obs.TraceRecorder``)
records where the host's time goes inside ``OfflineEngine.step``: the
engine's phases (``engine`` track: ``reap``, ``prefill``, ``decode``), its
booking (``engine/host``: ``build_chunk``, ``apply_prefill``,
``apply_decode``) and the parts of the backend's calls (``backend``:
``decode.inputs``, ``decode.noise``, ``decode.launch``, ``decode.readout``,
``prefill.inputs``, ``prefill.launch``, ``prefill.wait``).  Its stamps are
``time.perf_counter`` seconds, tied to the epoch by the recorder's clock
anchor; a ``torch.profiler`` trace lays its events on the epoch too
(``ts`` µs after its ``baseTimeNanoseconds``).  So a recorder span lands
on the timeline ``bench/timeline.py`` reads at ``(epoch_ns -
base_ns) / 1e9`` seconds (``on_timeline``), and each idle second of the
card can be put under the innermost span the host was in
(``idle_by_span``; ``none`` where the host was in no program span).

A run that reads them carries, beside what ``bench/run.py`` gives its
readers: ``spans``, the recorder of a stretch of steps with the recorder
attached and no profiler (the profiler adds host time to every eager
operation and to a replay's launch), run before the profiled slice (a
process that has run the profiler launches more slowly afterwards);
``traced_spans``, the recorder attached through the profiled slice;
``base_ns``, that slice's trace's ``baseTimeNanoseconds``.  Readers return None where a run has none of
them (a program without the recorder's spans, or an untraced run).

As a command, from the root of a checkout, on the cell's card:

    python3 bench/spans.py --workload yi9b.decode_heavy --seed 12345 \\
        --seconds 20

builds and warms up the cell as ``bench/run.py`` does, measures a window
of ``--seconds`` with no recorder (0: none), then a recorder-only stretch
and a profiled slice with a recorder attached, ``--trace-seconds`` each,
and prints one JSON object: the span metrics (``bench/metrics/``), the
idle seconds by program span, the host split of a decode call and of a
step, each decode call's share covered by its spans, the clock check (the
engine's ``reap`` starts against the harness's ``bench.step`` spans) and
the harness's own figures beside them.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import statistics
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the recorder's tracks whose spans nest on the host's one thread (a pipe
# tick's span straddles the backend's and is left out)
NESTED_TRACKS = ("engine", "engine/host", "backend", "offload")
DECODE_PARTS = ("decode.inputs", "decode.noise", "decode.launch",
                "decode.readout")
# a decode call's host work before its replay runs: where the card waits
DECODE_HOST = ("decode.inputs", "decode.noise", "decode.launch")
STEP_HOST = ("reap", "build_chunk", "apply_prefill", "apply_decode")

Span = Tuple[float, float, str]


def wall_spans(rec, tracks: Sequence[str] = NESTED_TRACKS
               ) -> List[Tuple[float, float, str, tuple]]:
    """``(t0, t1, name, data)`` of the recorder's wall-clock spans on
    ``tracks``, on ``perf_counter`` seconds, by start."""
    return sorted((e.t0, e.t0 + e.dur, e.name, e.data) for e in rec.events
                  if e.kind == "span" and e.clock == "wall"
                  and e.track in tracks)


def on_timeline(rec, base_ns: int,
                tracks: Sequence[str] = NESTED_TRACKS) -> List[Span]:
    """The recorder's spans on a profiler trace's clock: seconds after
    ``base_ns``, as ``bench/timeline.read`` keeps the trace's events."""
    return [((rec.epoch_ns(t0) - base_ns) / 1e9,
             (rec.epoch_ns(t1) - base_ns) / 1e9, name)
            for t0, t1, name, _ in wall_spans(rec, tracks)]


def innermost(spans: Sequence[Span]) -> List[Span]:
    """Cut nested spans into consecutive pieces, each under the innermost
    span over it and ``none`` between them, from the first start to the
    last end.  A span that outlasts the one it started in is cut at that
    one's end."""
    out: List[Span] = []
    stack: List[Span] = []
    t = None

    def emit(lo, hi, name):
        if lo is not None and hi > lo:
            out.append((lo, hi, name))

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            emit(t, top[1], top[2])
            t = top[1]
        emit(t, s, stack[-1][2] if stack else "none")
        t = s
        if stack:
            e = min(e, stack[-1][1])
        stack.append((s, e, name))
    while stack:
        top = stack.pop()
        emit(t, top[1], top[2])
        t = top[1]
    return out


def split_by(intervals: Sequence[Tuple[float, float]],
             pieces: Sequence[Span]) -> Dict[str, float]:
    """Seconds of ``intervals`` under each piece's name (``innermost``),
    ``none`` outside every piece: each second lands under one name."""
    starts = [p[0] for p in pieces]
    out: Dict[str, float] = defaultdict(float)
    for lo, hi in intervals:
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(pieces) and pieces[i][0] < hi:
            a, b = max(lo, pieces[i][0]), min(hi, pieces[i][1])
            if b > a:
                out[pieces[i][2]] += b - a
                covered += b - a
            i += 1
        if hi - lo > covered:
            out["none"] += hi - lo - covered
    return dict(out)


def idle_by_span(tl, spans: Sequence[Span], n_cards: int) -> Dict[str, float]:
    """The device's idle seconds in the traced slice under the innermost
    program span the host was in (``none``: in none), by overlap, the mean
    over ``n_cards`` cards (a card with no operation is idle throughout)."""
    pieces = innermost([(max(s, tl.t0), min(e, tl.t1), n)
                        for s, e, n in spans if e > tl.t0 and s < tl.t1])
    out: Dict[str, float] = defaultdict(float)
    for card in range(n_cards):
        gaps = tl.idle_gaps(card) if card in tl.ops else [(tl.t0, tl.t1)]
        for name, sec in split_by(gaps, pieces).items():
            out[name] += sec / n_cards
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# -- what the readers read -----------------------------------------------


def per_call_ms(rec, name: str) -> Optional[float]:
    """Mean ms of the spans ``name`` (one a call) in ``rec``."""
    if rec is None:
        return None
    durs = [t1 - t0 for t0, t1, n, _ in wall_spans(rec) if n == name]
    return 1e3 * sum(durs) / len(durs) if durs else None


def host_ms_step(rec) -> Optional[float]:
    """The engine's own host ms a step: ``reap`` and the ``engine/host``
    spans, over the steps (one ``reap`` a step)."""
    if rec is None:
        return None
    spans = wall_spans(rec, ("engine", "engine/host"))
    steps = sum(1 for *_, n, _ in spans if n == "reap")
    if not steps:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, n, _ in spans
                     if n in STEP_HOST) / steps


def traced_idle(run) -> Optional[Dict[str, float]]:
    """``idle_by_span`` of a traced run's slice, or None."""
    tl, rec = getattr(run, "timeline", None), getattr(run, "traced_spans",
                                                      None)
    base = getattr(run, "base_ns", None)
    if tl is None or not tl.ops or rec is None or base is None or \
            tl.window_s <= 0.0:
        return None
    return idle_by_span(tl, on_timeline(rec, base), run.cards)


# -- the checks ------------------------------------------------------------


def clock_check(tl, rec, base_ns: int) -> Optional[dict]:
    """Each ``reap`` span start of the profiled slice, through the anchor,
    against the harness's ``bench.step`` spans: the share that falls
    inside one, and the lead after that span's start (µs)."""
    steps = sorted(tl.spans_named("bench.step"))
    reaps = [s for s, _, n in on_timeline(rec, base_ns, ("engine",))
             if n == "reap" and tl.t0 <= s <= tl.t1]
    if not steps or not reaps:
        return None
    starts = [s for s, _ in steps]
    leads = []
    for r in reaps:
        i = bisect.bisect_right(starts, r) - 1
        if i >= 0 and r <= steps[i][1]:
            leads.append(1e6 * (r - steps[i][0]))
    return {"steps": len(reaps), "inside_share": len(leads) / len(reaps),
            "lead_us_median": statistics.median(leads) if leads else None,
            "lead_us_max": max(leads) if leads else None}


def mapping_check(tl, rec, base_ns: int, steps) -> Optional[dict]:
    """The anchor's own error, seen through the harness: each step's
    ``perf_counter`` stamp, taken just before its ``bench.step`` span
    opens, mapped onto the trace, against that span's start (µs; the
    span's start minus the stamp's place, so the profiler's cost of
    opening a span is in it)."""
    starts = sorted(s for s, _ in tl.spans_named("bench.step"))
    if not starts or not steps:
        return None
    offs = []
    for ts, _ in steps:
        t = (rec.epoch_ns(ts) - base_ns) / 1e9
        i = bisect.bisect_left(starts, t)
        near = [starts[j] for j in (i - 1, i) if 0 <= j < len(starts)]
        offs.append(1e6 * (min(near, key=lambda x: abs(x - t)) - t))
    return {"steps": len(offs), "offset_us_median": statistics.median(offs),
            "offset_us_min": min(offs), "offset_us_max": max(offs)}


def host_lead(rec, steps) -> Optional[dict]:
    """On the host's one clock, with no profiler: each ``reap`` start after
    the harness's stamp of its step (µs)."""
    reaps = sorted(s for s, _, n, _ in wall_spans(rec, ("engine",))
                   if n == "reap")
    leads = []
    for ts, te in steps:
        i = bisect.bisect_left(reaps, ts)
        if i < len(reaps) and reaps[i] <= te:
            leads.append(1e6 * (reaps[i] - ts))
    if not leads:
        return None
    return {"steps": len(leads), "lead_us_median": statistics.median(leads),
            "lead_us_max": max(leads)}


def coverage(calls, rec) -> Optional[dict]:
    """Each harness-timed decode call's host time covered by the four
    ``decode.*`` spans that start inside it."""
    parts = [(t0, t1) for t0, t1, n, _ in wall_spans(rec, ("backend",))
             if n in DECODE_PARTS]
    starts = [p[0] for p in parts]
    shares = []
    for c in calls:
        i = bisect.bisect_left(starts, c.t0)
        got = 0.0
        while i < len(parts) and parts[i][0] <= c.t1:
            got += min(parts[i][1], c.t1) - parts[i][0]
            i += 1
        shares.append(got / (c.t1 - c.t0))
    if not shares:
        return None
    return {"calls": len(shares), "min": min(shares),
            "median": statistics.median(shares),
            "share_at_least_95": sum(s >= 0.95 for s in shares)
            / len(shares)}


def host_split(rec) -> Optional[dict]:
    """Host ms by span name: a decode call's parts (per call) and every
    span a step (over the steps)."""
    if rec is None:
        return None
    spans = wall_spans(rec)
    steps = sum(1 for *_, n, _ in spans if n == "reap")
    total: Dict[str, float] = defaultdict(float)
    for t0, t1, n, _ in spans:
        total[n] += t1 - t0
    return {"decode_call_ms": {n: per_call_ms(rec, n) for n in DECODE_PARTS},
            "step_ms": {n: 1e3 * v / steps for n, v in sorted(total.items())}
            if steps else {}, "steps": steps}


# -- the command -------------------------------------------------------------


def base_ns_of(path: str) -> int:
    """A profiler trace's ``baseTimeNanoseconds``."""
    with open(path, "rb") as fh:
        fh.seek(max(0, os.path.getsize(path) - 65536))
        m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', fh.read())
    if m:
        return int(m.group(1))
    with open(path) as fh:
        return int(json.load(fh)["baseTimeNanoseconds"])


METRICS = ("decode.inputs_ms", "decode.noise_ms", "decode.wait_ms",
           "engine.host_ms_step", "idle.decode_host_share")
# the harness's own readings of the same layers, beside them
HARNESS = ("graphs.host_ms_tick", "graphs.device_ms_tick",
           "device.idle_share")


def collect(cell, seed: int, seconds: float, trace_seconds: float, device,
            root: Path) -> dict:
    """Run the cell (see the module docstring); the result object."""
    import torch

    from bench import serve, spec
    from bench import timeline as timeline_lib
    from bench.run import Run
    from repro_torch.obs import TraceRecorder

    runner = serve.Runner(cell, seed, device)
    runner.warm_up()
    engine = runner.engine
    window = runner.run_phase(seconds) if seconds > 0 else None
    rec, traced_rec = TraceRecorder(), TraceRecorder()
    engine.set_recorder(rec)
    stretch = runner.run_phase(trace_seconds)
    engine.set_recorder(traced_rec)
    path = serve.trace_path(root)
    try:
        traced = runner.traced_phase(trace_seconds, path)
    finally:
        engine.set_recorder(None)
    tl = timeline_lib.read(path)
    base = base_ns_of(path)
    os.remove(path)
    del engine
    runner.free_engine()

    dtype = getattr(torch, cell.config["dtype"])
    run = Run(phase=window or stretch, traced=traced, timeline=tl,
              sizes=runner.sizes, arch=cell.arch, cards=cell.chips,
              pages_seq=runner.pages_seq, cell=cell,
              esize=torch.empty((), dtype=dtype).element_size(),
              dtype_name=cell.config["dtype"], spans=rec,
              traced_spans=traced_rec, base_ns=base)

    def read(name, r=run):
        v = spec.load_reader(name, cell.bench_dir)(r)
        return None if v is None else float(v)

    harness = {n: read(n) for n in HARNESS}
    harness["graphs.host_ms_tick.stretch"] = read(
        "graphs.host_ms_tick", Run(phase=stretch))
    harness["graphs.host_ms_tick.traced"] = read(
        "graphs.host_ms_tick", Run(phase=traced))
    if window is None:
        harness.pop("graphs.host_ms_tick")
    idle = traced_idle(run) or {}
    return {"metrics": {n: read(n) for n in METRICS},
            "idle_by_span": idle,
            "idle_s": sum(idle.values()), "window_s": tl.window_s,
            "idle_gaps": timeline_lib.breakdown(tl, cell.chips)["idle_gaps"],
            "split": host_split(rec),
            "split_traced": host_split(traced_rec),
            "coverage": coverage(stretch.decode, rec),
            "clock": clock_check(tl, traced_rec, base),
            "clock_mapping": mapping_check(tl, traced_rec, base,
                                           traced.steps),
            "clock_host_lead": host_lead(rec, stretch.steps),
            "harness": harness,
            "recorder": {"events": len(rec.events), "dropped": rec.dropped,
                         "traced_events": len(traced_rec.events),
                         "traced_dropped": traced_rec.dropped},
            "steps": {"window": len(window.steps) if window else 0,
                      "traced": len(traced.steps),
                      "stretch": len(stretch.steps)}}


def main(argv=None) -> int:
    from bench.run import ROOT, card_info, set_environment

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace-seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    set_environment(ROOT)

    import torch

    from bench import spec

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    if args.device.startswith("cuda") and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    out = collect(cell, args.seed, args.seconds, args.trace_seconds,
                  args.device, ROOT)
    out["card"] = card_info() if args.device.startswith("cuda") else None
    out["workload"], out["seed"] = args.workload, args.seed
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
