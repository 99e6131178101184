"""Ring-buffer span/event recorder with a dual timeline (own copy of
``repro.obs.trace``, no torch).

One :class:`TraceRecorder` serves one engine.  Every recording helper is
a plain host-side append of already-materialised values — a perf_counter
stamp the engine took anyway, a virtual-clock float the transport just
computed, an int the return-link sync already brought to host.  Nothing
here may touch a device value: an argument read from a CUDA tensor
would add a device sync per call (the ``obs-hot-path`` rule of
:mod:`repro_torch.analysis.lint` enforces it), and every call site in the
serving core is gated on ``recorder is not None`` so the hot path pays
zero when tracing is off.

Two clocks, tagged per event:

* ``"wall"`` — ``time.perf_counter()`` seconds.  Engine step phases,
  pipe ticks, offload windows, per-request latency stamps.
* ``"virtual"`` — the transport layer's :class:`~repro_torch
  .distributed.transport.VirtualClock` seconds.  Per-stage busy windows, per-link
  transfers, stall ledger entries.  A 64 ms WAN run records a 64 ms
  timeline while costing CPU-milliseconds of wall time.

The wall clock is tied to the epoch once, when the recorder is made: its
``anchor`` is the tightest of a few back-to-back ``(time.perf_counter(),
time.time_ns())`` pairs, and :meth:`TraceRecorder.epoch_ns` maps any wall
stamp through it.  ``torch.profiler`` lays host and device events on the
epoch (``ts`` µs after its trace's ``baseTimeNanoseconds``), so a wall
stamp lands on a profiler trace at ``(epoch_ns(t) - baseTimeNanoseconds)
/ 1e3`` µs (:func:`repro_torch.obs.timeline.chrome_trace_events`'s
``base_ns``).

Where the work happens, the serving core records spans on tracks of
their own: ``backend`` (inside a backend's decode and prefill calls:
``decode.inputs`` / ``decode.noise`` / ``decode.launch`` /
``decode.readout``, ``prefill.inputs`` / ``prefill.launch`` /
``prefill.wait``) and ``engine/host`` (the engine's own booking:
``build_chunk``, ``apply_prefill``, ``apply_decode``), beside the
``engine`` track's ``reap`` / ``prefill`` / ``decode`` phases.

**Ledger events** (``link_send`` / ``tick_stall``) are recorded at the
exact sites where :class:`SimulatedLinkTransport` accumulates its books:
summing the recorded ``nbytes`` ints reproduces ``wire_bytes``
*bitwise*, counting the sends reproduces ``sends``, and summing the
per-tick ``tick_stall`` floats left-to-right reproduces ``stall_s``
bitwise (same floats added in the same order).  The port's tests and
``chip_smoke.py``'s traced pipeline both reconcile through
:meth:`TraceRecorder.link_ledger`.

The event buffer is a bounded ring (``capacity`` events, oldest evicted
first; ``dropped`` counts evictions — never a silent cap).  Per-request
traces live in a separate bounded dict keyed by request id and surface
on ``RequestOutput.trace``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Event", "TraceRecorder", "WALL", "VIRTUAL", "clock_anchor"]

WALL = "wall"
VIRTUAL = "virtual"

# the tracks of the spans inside a backend call and of the engine's booking
BACKEND_TRACK = "backend"
ENGINE_HOST_TRACK = "engine/host"

# event kinds -> how repro_torch.obs.timeline renders them
SPAN = "span"          # complete slice (ph "X")
ASYNC = "async"        # possibly-overlapping slice (ph "b"/"e" pair)
INSTANT = "instant"    # point event (ph "i")
COUNTER = "counter"    # sampled value (ph "C")


def clock_anchor(pairs: int = 8) -> Tuple[float, int]:
    """``(perf_counter seconds, epoch ns)`` taken at one instant: of
    ``pairs`` epoch reads, the one whose bracketing ``perf_counter``
    reads lie closest together, against their midpoint."""
    best = None
    for _ in range(pairs):
        a = time.perf_counter()
        ns = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, 0.5 * (a + b), ns)
    return best[1], best[2]


class Event(NamedTuple):
    """One recorded event.  ``data`` is a tuple of ``(key, value)``
    pairs (immutable, cheap to build, dict-able at export time)."""
    kind: str
    name: str
    clock: str
    track: str
    t0: float
    dur: float
    data: Tuple


class TraceRecorder:
    """Bounded flight recorder threaded through the serving stack.

    ``capacity`` bounds the event ring; ``max_requests`` bounds the
    per-request trace table (oldest *finished* entries evicted first).
    All helpers are safe to call from the engine's single-threaded step
    loop; the online pump serialises its calls behind the engine lock.
    """

    def __init__(self, capacity: int = 65536, max_requests: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.max_requests = max_requests
        self.requests: Dict[int, dict] = {}
        self._finished_order: deque = deque()
        self.created_at = time.perf_counter()
        self.anchor = clock_anchor()

    def epoch_ns(self, t: float) -> int:
        """Wall stamp ``t`` (``perf_counter`` seconds) as epoch
        nanoseconds, through the recorder's ``anchor``."""
        perf, ns = self.anchor
        return ns + round((t - perf) * 1e9)

    # -- core appends -----------------------------------------------------

    def _append(self, kind, name, clock, track, t0, dur, data) -> None:
        ev = self.events
        if len(ev) == self.capacity:
            self.dropped += 1
        ev.append(Event(kind, name, clock, track, t0, dur, data))

    def span(self, name: str, track: str, t0: float, t1: float,
             clock: str = WALL, data: Tuple = ()) -> None:
        self._append(SPAN, name, clock, track, t0, t1 - t0, data)

    def instant(self, name: str, track: str, t: float,
                clock: str = WALL, data: Tuple = ()) -> None:
        self._append(INSTANT, name, clock, track, t, 0.0, data)

    # -- engine step phases (wall clock) ----------------------------------

    def step_phase(self, name: str, t0: float, t1: float,
                   step: int) -> None:
        """One phase of one engine step: "reap" / "prefill" / "decode" /
        "admit" — recorded from the stamps ``OfflineEngine.step`` takes
        for ``EngineStats`` anyway."""
        self._append(SPAN, name, WALL, "engine", t0, t1 - t0,
                     (("step", step),))

    def pipe_tick(self, plane: str, t0: float, t1: float,
                  occupancy: Tuple) -> None:
        """One backend pipe tick (wall): which microbatch/chunk sat in
        each stage slot this tick (host ints the scheduler holds)."""
        self._append(SPAN, "tick", WALL, f"pipe/{plane}", t0, t1 - t0,
                     (("occupancy", occupancy),))

    # -- transport ledger (virtual clock) ---------------------------------

    def link_send(self, plane: str, link: int, nbytes: int,
                  t0: float, t1: float, return_trip: bool = False) -> None:
        """One payload crossing one ring link — recorded at the exact
        site where the transport does ``wire_bytes += nbytes``, so the
        recorded ints sum to the book bitwise."""
        self._append(ASYNC, "return" if return_trip else "send", VIRTUAL,
                     f"link{link}", t0, t1 - t0,
                     (("plane", plane), ("nbytes", nbytes)))

    def tick_stall(self, plane: str, stall_s: float, t: float) -> None:
        """The per-tick stall total, the same float the transport adds to
        its ``stall_s`` book (one entry per ``tick()`` call, in call
        order, so a left-to-right sum reproduces the ledger bitwise)."""
        self._append(COUNTER, "stall", VIRTUAL, f"stall/{plane}", t, 0.0,
                     (("stall_s", stall_s),))

    def stage_busy(self, plane: str, stage: int, t0: float,
                   t1: float) -> None:
        """One stage's compute window on the virtual clock (start =
        max(prev done, input arrival), end = the transport's ``done[s]``
        — monotone per stage by construction)."""
        self._append(SPAN, "busy", VIRTUAL, f"stage{stage}", t0, t1 - t0,
                     (("plane", plane),))

    def link_ledger(self) -> Dict[str, float]:
        """Re-derive the transport books from the recorded ledger events:
        ``{"wire_bytes": int, "sends": int, "stall_s": float}``.  Exact
        (bitwise) against ``SimulatedLinkTransport`` when the ring has
        not evicted any ledger event (``dropped == 0``)."""
        wire = 0
        sends = 0
        stall = 0.0
        for e in self.events:
            if e.kind == ASYNC and e.name in ("send", "return"):
                wire += e.data[1][1]
                sends += 1
            elif e.kind == COUNTER and e.name == "stall":
                stall += e.data[0][1]
        return {"wire_bytes": wire, "sends": sends, "stall_s": stall}

    # -- offload windows (wall clock) -------------------------------------

    def offload_swap_out(self, mb: int, t: float, asynchronous: bool
                         ) -> None:
        self._append(INSTANT, "swap_out", WALL, "offload", t, 0.0,
                     (("mb", mb), ("async", asynchronous)))

    def offload_swap_in(self, mb: int, t0: float, t1: float) -> None:
        """The swap-in wait window: how long ``ensure_resident`` blocked
        on the staged copy (t1 - t0 is the part the double-buffer failed
        to hide under compute)."""
        self._append(SPAN, "swap_in", WALL, "offload", t0, t1 - t0,
                     (("mb", mb),))

    # -- scheduler decisions (wall clock) ---------------------------------

    def prefix_event(self, kind: str, request_id: int, tokens: int,
                     t: float) -> None:
        """Prefix-cache activity: kind is "hit" / "insert" / "evict"."""
        self._append(INSTANT, f"prefix_{kind}", WALL, "prefix", t, 0.0,
                     (("request_id", request_id), ("tokens", tokens)))

    def slo_budget(self, frac: float, budget: int, t: float) -> None:
        self._append(COUNTER, "slo_budget", WALL, "slo", t, 0.0,
                     (("frac", frac), ("budget", budget)))

    def fault(self, kind: str, t: float, data: Tuple = ()) -> None:
        """Fault injections and recoveries: kind is "drop" / "delay" /
        "recover"."""
        self._append(INSTANT, f"fault_{kind}", WALL, "faults", t, 0.0,
                     data)

    def reshard_span(self, phase: str, t0: float, t1: float,
                     data: Tuple = ()) -> None:
        """Reshard lifecycle: phase is "drain" / "rebuild"."""
        self._append(SPAN, f"reshard_{phase}", WALL, "reshard", t0,
                     t1 - t0, data)

    # -- per-request traces -----------------------------------------------

    def _req(self, request_id: int) -> Optional[dict]:
        return self.requests.get(request_id)

    def request_submit(self, request_id: int, t: float,
                       prompt_len: int) -> None:
        if len(self.requests) >= self.max_requests:
            while self._finished_order:
                old = self._finished_order.popleft()
                if self.requests.pop(old, None) is not None:
                    break
            else:
                return                      # table full of live requests
        self.requests[request_id] = {
            "request_id": request_id, "prompt_len": prompt_len,
            "submit_time": t, "admit_time": None,
            "first_token_time": None, "token_times": [],
            "chunks": 0, "pages": 0, "prefix_hit_tokens": 0,
            "finish_time": None, "finish_reason": None,
            # online (stream-side) stamps, when an OnlineLLM fronts the
            # engine: the SAME floats RequestStream holds, so derived
            # TTFT/ITL match the stream's reports bitwise
            "stream_submit_time": None, "delivery_times": [],
        }

    def request_admit(self, request_id: int, t: float) -> None:
        r = self._req(request_id)
        if r is not None and r["admit_time"] is None:
            r["admit_time"] = t

    def request_first_token(self, request_id: int, t: float) -> None:
        r = self._req(request_id)
        if r is not None and r["first_token_time"] is None:
            r["first_token_time"] = t

    def request_tokens(self, request_id: int, n: int, t: float) -> None:
        """``n`` tokens sampled for this request at engine-step stamp
        ``t`` (one stamp per step — the engine's own step-end clock)."""
        r = self._req(request_id)
        if r is not None:
            r["token_times"].extend([t] * n)

    def request_chunk(self, request_id: int, tokens: int) -> None:
        r = self._req(request_id)
        if r is not None:
            r["chunks"] += 1

    def request_pages(self, request_id: int, n: int) -> None:
        r = self._req(request_id)
        if r is not None:
            r["pages"] += n

    def request_prefix_hit(self, request_id: int, tokens: int) -> None:
        r = self._req(request_id)
        if r is not None:
            r["prefix_hit_tokens"] += tokens

    def request_finish(self, request_id: int, t: float,
                       reason: Optional[str]) -> None:
        r = self._req(request_id)
        if r is not None and r["finish_time"] is None:
            r["finish_time"] = t
            r["finish_reason"] = reason
            self._finished_order.append(request_id)
            if len(self._finished_order) > 4 * self.max_requests:
                # drop stale entries (already-evicted request ids)
                self._finished_order = deque(
                    rid for rid in self._finished_order
                    if rid in self.requests)

    # stream-side stamps (OnlineLLM): the exact floats RequestStream uses
    def request_stream_submit(self, request_id: int, t: float) -> None:
        r = self._req(request_id)
        if r is not None:
            r["stream_submit_time"] = t

    def request_delivery(self, request_id: int, t: float,
                         n: int = 1) -> None:
        r = self._req(request_id)
        if r is not None:
            r["delivery_times"].extend([t] * n)

    def request_trace(self, request_id: int) -> Optional[dict]:
        """Snapshot of one request's trace with derived latencies:
        ``queue_wait_s`` (submit → admitted into a slot), ``ttft_s``
        (submit → first token sampled; stream-side when online stamps
        exist), ``inter_token_s`` (consecutive token-stamp deltas)."""
        r = self._req(request_id)
        if r is None:
            return None
        out = dict(r)
        out["token_times"] = list(r["token_times"])
        out["delivery_times"] = list(r["delivery_times"])
        sub, adm = r["submit_time"], r["admit_time"]
        out["queue_wait_s"] = None if adm is None else adm - sub
        if r["delivery_times"] and r["stream_submit_time"] is not None:
            # stream-side: identical floats to RequestStream.ttft_s /
            # inter_token_s() — same stamps, same subtractions
            ts = r["delivery_times"]
            out["ttft_s"] = ts[0] - r["stream_submit_time"]
            out["inter_token_s"] = [b - a for a, b in zip(ts, ts[1:])]
        else:
            ft = r["first_token_time"]
            out["ttft_s"] = None if ft is None else ft - sub
            ts = r["token_times"]
            out["inter_token_s"] = [b - a for a, b in zip(ts, ts[1:])]
        return out

    # -- summaries --------------------------------------------------------

    def summary(self) -> Dict:
        return {"events": len(self.events), "dropped": self.dropped,
                "requests": len(self.requests),
                **self.link_ledger()}
