"""Chrome-trace-event (Perfetto-loadable) timeline export (own copy of
``repro.obs.timeline``).

``chrome_trace_events`` turns a :class:`~repro_torch.obs.trace.TraceRecorder`
into the JSON object format Perfetto / ``chrome://tracing`` load
directly: open https://ui.perfetto.dev and drop the file in.

Track layout — the picture the §4.3 schedule comparison needs:

* **pid 1 "wall clock"** — the engine's real time: one ``engine`` track
  of step phases (reap / prefill / decode), one ``pipe/<plane>`` track
  per pipe plane (each tick a slice whose args carry the stage
  occupancy), the ``offload`` swap windows, and instant markers for
  prefix-cache hits/evictions, SLO budget decisions, faults, reshard
  drain/rebuild.
* **pid 2 "virtual clock"** — the transport's simulated time: one
  ``stage<s>`` track per pipeline stage (busy windows — the circular
  schedule shows as a dense brick wall, round-flush as bubbles), and
  per-link transfers as async slices (``ph "b"/"e"`` — transfers
  legitimately overlap when the link delay exceeds a stage tick, which
  complete-X slices cannot express).  Each transfer's ``nbytes`` rides
  in its args: summing them over the exported JSON reconciles bitwise
  with ``SimulatedLinkTransport.wire_bytes`` (ints survive the JSON
  round trip exactly), and the ``stall`` counter series reconciles the
  same way against ``stall_s``.

Beside a device trace: ``base_ns`` (a ``torch.profiler`` trace's
``baseTimeNanoseconds``) lays the wall events on that trace's time base
through the recorder's clock anchor (:meth:`~repro_torch.obs.trace
.TraceRecorder.epoch_ns`), so the two exports' ``traceEvents`` can be
concatenated and read in one Perfetto view, host phases beside kernels.
Wall events that started before the profiler's base are left out and
counted (``otherData["before_base"]``).  ``otherData`` always carries the
anchor (``clock_anchor``: ``perf_counter_s``, ``epoch_ns``).

``validate_chrome_trace`` is the schema check the CI audit job runs
(also exposed as ``python -m repro_torch.obs.timeline --check out.json``):
structural keys per phase type, finite non-negative timestamps, b/e
pairing, and per-track monotonicity of complete slices.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Dict, List, Optional, Union

from repro_torch.obs.trace import (ASYNC, COUNTER, INSTANT, SPAN, TraceRecorder,
                             VIRTUAL, WALL)

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "validate_chrome_trace"]

_PIDS = {WALL: 1, VIRTUAL: 2}
_US = 1e6


def chrome_trace_events(rec: TraceRecorder,
                        base_ns: Optional[int] = None) -> Dict:
    """``{"traceEvents": [...], ...}`` in Chrome JSON object format; wall
    events start near 0, or with ``base_ns`` on a profiler trace's time
    base (see the module docstring)."""
    events: List[Dict] = []
    for clock, pid in _PIDS.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"{clock} clock"}})
    tids: Dict = {}

    def tid_of(pid: int, track: str) -> int:
        key = (pid, track)
        t = tids.get(key)
        if t is None:
            t = tids[key] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": t, "args": {"name": track}})
        return t

    # normalise the wall clock so the timeline starts near 0 (perf_counter
    # has an arbitrary epoch); the virtual clock already starts at 0
    wall0 = min((e.t0 for e in rec.events if e.clock == WALL),
                default=0.0)
    async_id = before_base = 0
    for e in rec.events:
        if e.clock == VIRTUAL:
            t0 = e.t0
        elif base_ns is None:
            t0 = e.t0 - wall0
        else:
            t0 = (rec.epoch_ns(e.t0) - base_ns) / 1e9
            if t0 < 0.0:
                before_base += 1
                continue
        pid = _PIDS[e.clock]
        tid = tid_of(pid, e.track)
        args = dict(e.data)
        if e.kind == SPAN:
            events.append({"name": e.name, "ph": "X", "pid": pid,
                           "tid": tid, "ts": t0 * _US,
                           "dur": max(e.dur, 0.0) * _US, "args": args})
        elif e.kind == ASYNC:
            async_id += 1
            base = {"name": e.name, "cat": e.track, "pid": pid,
                    "tid": tid, "id": async_id}
            events.append({**base, "ph": "b", "ts": t0 * _US,
                           "args": args})
            events.append({**base, "ph": "e",
                           "ts": (t0 + max(e.dur, 0.0)) * _US})
        elif e.kind == COUNTER:
            events.append({"name": e.name, "ph": "C", "pid": pid,
                           "tid": tid, "ts": t0 * _US, "args": args})
        else:                       # INSTANT
            events.append({"name": e.name, "ph": "i", "pid": pid,
                           "tid": tid, "ts": t0 * _US, "s": "t",
                           "args": args})
    other = {"recorder_events": len(rec.events),
             "recorder_dropped": rec.dropped,
             "clock_anchor": {"perf_counter_s": rec.anchor[0],
                              "epoch_ns": rec.anchor[1]}}
    if base_ns is not None:
        other.update(base_ns=base_ns, before_base=before_base)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(rec: TraceRecorder, path: str,
                       base_ns: Optional[int] = None) -> Dict:
    """Export ``rec`` to ``path`` (Perfetto-loadable JSON), on a profiler
    trace's time base with ``base_ns``; returns the trace object it
    wrote."""
    trace = chrome_trace_events(rec, base_ns)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


# ---------------------------------------------------------------------------
# Schema check (CI audit job)
# ---------------------------------------------------------------------------


def validate_chrome_trace(trace: Union[Dict, List]) -> List[str]:
    """Structural validation of a Chrome-trace JSON object; returns a
    list of problems (empty = valid).  Checks: ``traceEvents`` shape,
    required keys per phase type, finite non-negative timestamps and
    durations, b/e async pairing, and per-``(pid, tid)`` monotone
    ordering of complete ("X") slices."""
    errs: List[str] = []
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level 'traceEvents' missing or not a list"]
    elif isinstance(trace, list):
        events = trace
    else:
        return [f"trace must be a dict or list, got {type(trace).__name__}"]

    def bad(i, msg):
        if len(errs) < 50:
            errs.append(f"event[{i}]: {msg}")

    last_x_ts: Dict = {}
    open_async: Dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            bad(i, f"not an object: {ev!r}")
            continue
        ph = ev.get("ph")
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            bad(i, "missing event name")
        if ph not in ("X", "i", "I", "b", "e", "n", "C", "M", "B", "E"):
            bad(i, f"unknown phase {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0:
            bad(i, f"ts={ts!r} must be a finite number >= 0")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or \
                    not math.isfinite(dur) or dur < 0:
                bad(i, f"complete slice dur={dur!r} must be >= 0")
            if "pid" not in ev or "tid" not in ev:
                bad(i, "complete slice missing pid/tid")
            else:
                key = (ev["pid"], ev["tid"])
                prev = last_x_ts.get(key)
                if prev is not None and ts < prev:
                    bad(i, f"track {key}: slice ts {ts} < previous "
                           f"{prev} — per-track timestamps must be "
                           "monotone")
                last_x_ts[key] = ts
        elif ph in ("b", "e"):
            if "id" not in ev or "cat" not in ev:
                bad(i, f"async event missing id/cat: {ev}")
                continue
            key = (ev["cat"], ev["id"])
            if ph == "b":
                if key in open_async:
                    bad(i, f"async {key} begun twice")
                open_async[key] = ts
            else:
                t0 = open_async.pop(key, None)
                if t0 is None:
                    bad(i, f"async end {key} without a begin")
                elif ts < t0:
                    bad(i, f"async {key} ends at {ts} before its begin "
                           f"{t0}")
    for key in open_async:
        if len(errs) < 50:
            errs.append(f"async {key} never ended")
    return errs


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.timeline",
        description="validate an exported Chrome-trace timeline")
    ap.add_argument("--check", metavar="PATH", required=True,
                    help="trace JSON to validate")
    args = ap.parse_args(argv)
    try:
        with open(args.check) as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"timeline: cannot load {args.check}: {e}", file=sys.stderr)
        return 2
    errs = validate_chrome_trace(trace)
    for e in errs:
        print(f"timeline: {e}")
    # a bare event list is a valid trace file too (the reference's
    # ``trace.get`` raises on one: ROADMAP Queue 3)
    events = trace.get("traceEvents") if isinstance(trace, dict) else trace
    n = len(events) if isinstance(events, list) else 0
    print(f"timeline: {args.check}: "
          + (f"{len(errs)} problem(s) in {n} event(s)" if errs
             else f"valid ({n} events)"))
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
