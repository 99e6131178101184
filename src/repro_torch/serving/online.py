"""Online (submit-while-running) serving front end (counterpart of
``repro.serving.online``).

:class:`OnlineLLM` turns the pull-based offline engine into a live
service: ``submit()`` may be called at any time, including while the
engine loop is mid-drain, and returns a :class:`RequestStream` that yields
tokens per engine tick, not after the batch finishes.  Continuous
batching already admits into a live loop (the queue is drained into free
slots every tick), so the front end is orchestration only: an admission
inbox, a delivery cursor per request, and an optional pump thread.

Two pump modes, one delivery surface:

* **cooperative** (the default): no thread.  A consumer blocked on
  ``stream.next_event()`` drives ``OnlineLLM.step()`` itself until its
  event arrives: one thread, deterministic.
* **threaded**: ``start()`` launches a daemon pump; ``submit()`` from any
  thread wakes it, consumers wait on a condition variable, and
  ``close()`` stops it.  (``RequestStream.__aiter__`` runs the blocking
  ``next_event`` in the event loop's default executor.)  An error inside
  the engine ends the pump and is raised to every consumer.

The engine is stepped under one lock, so the cooperative path and the
pump never step it at the same time, and always on the engine's own
streams (``OfflineEngine.stream_context``: one a stage card, captured when
it was built): a new thread starts on each card's default stream, and the
engine's work, paged-attention launches included, must stay on one stream
a card, in order.

Token streams equal offline ``LLM.generate``'s: every token is a function
of ``(seed, request_id, token_idx)`` only, so arrival times, admission
order and prefix-cache hits change *when* a token is delivered, never
*which* token.  Each :class:`StreamEvent` is stamped when the pump books
it; ``RequestStream.ttft_s`` / ``inter_token_s()`` give the samples of
time to first token and inter-token latency.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.serving.llm import LLM, EngineConfig, RequestOutput
from repro_torch.serving.request import SamplingParams, SequenceState, Status

__all__ = ["OnlineLLM", "RequestStream", "StreamEvent"]


@dataclass(frozen=True)
class StreamEvent:
    """One delivered token of one online request."""
    request_id: int
    index: int                  # token index in the generated stream
    token: int
    time: float                 # perf_counter at delivery (pump side)
    finished: bool = False      # True on the request's last token
    finish_reason: Optional[str] = None


class RequestStream:
    """Per-request token stream handed back by :meth:`OnlineLLM.submit`.

    Iterate it (``for`` or ``async for``) or call :meth:`next_event`;
    ``None`` (StopIteration) marks the end.  With no pump thread running,
    the consumer steps the engine itself (cooperative mode)."""

    def __init__(self, online: "OnlineLLM", request_id: int,
                 prompt: List[int]):
        self._online = online
        self.request_id = request_id
        self.prompt = prompt
        self.seq: Optional[SequenceState] = None    # bound at admission
        self.submit_time = time.perf_counter()
        self._events: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._tokens: List[int] = []
        self._event_times: List[float] = []
        self.first_token_time: Optional[float] = None

    # -- producer side (pump) -------------------------------------------

    def _push(self, ev: StreamEvent) -> None:
        with self._cv:
            if self.first_token_time is None:
                self.first_token_time = ev.time
            self._event_times.append(ev.time)
            self._tokens.append(ev.token)
            self._events.append(ev)
            if ev.finished:
                self._closed = True
            self._cv.notify_all()

    def _wake(self) -> None:
        with self._cv:
            self._cv.notify_all()

    # -- consumer side ----------------------------------------------------

    def next_event(self, timeout: Optional[float] = None
                   ) -> Optional[StreamEvent]:
        """The next :class:`StreamEvent`, or ``None`` when the stream is
        complete.  Waits for the pump thread, or steps the engine here
        (cooperative mode), until one is there; raises the pump's error if
        the engine failed."""
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        while True:
            with self._cv:
                if self._events:
                    return self._events.popleft()
                if self._closed:
                    return None
                self._online._raise_pump_error()
                if self._online._thread is not None:
                    wait = 0.1 if deadline is None else \
                        deadline - time.perf_counter()
                    if wait <= 0 or not self._cv.wait(timeout=wait):
                        if deadline is not None and \
                                time.perf_counter() >= deadline:
                            raise TimeoutError(
                                f"request {self.request_id}: no token "
                                f"within {timeout}s")
                    continue
            # cooperative: drive the shared engine until our event lands
            if not self._online.step():
                with self._cv:
                    if self._events or self._closed:
                        continue
                raise RuntimeError(
                    f"request {self.request_id}: engine drained with the "
                    "stream still open (was the engine aborted?)")

    def __iter__(self):
        while True:
            ev = self.next_event()
            if ev is None:
                return
            yield ev

    def __aiter__(self):
        return self._agen()

    async def _agen(self):
        import asyncio
        loop = asyncio.get_running_loop()
        while True:
            ev = await loop.run_in_executor(None, self.next_event)
            if ev is None:
                return
            yield ev

    # -- results / metrics ------------------------------------------------

    @property
    def finished(self) -> bool:
        with self._cv:
            return self._closed and not self._events

    def tokens(self) -> List[int]:
        """Tokens delivered so far."""
        with self._cv:
            return list(self._tokens)

    def result(self) -> RequestOutput:
        """Drain the stream and return the final :class:`RequestOutput`,
        the online counterpart of ``LLM.generate``'s."""
        for _ in self:
            pass
        if self.seq is None:
            raise RuntimeError(f"request {self.request_id} was never "
                               "admitted")
        # the engine reaps a finished sequence on the tick after its last
        # token (freeing the slot, stamping finish time and status)
        while self.seq.status is not Status.FINISHED and self._online.step():
            pass
        return RequestOutput.from_seq(
            self.seq,
            trace=self._online.engine.request_trace(self.request_id))

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit to first delivered token, pump side (None until then)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    def inter_token_s(self) -> List[float]:
        """Deltas between consecutive delivery stamps (ITL samples)."""
        with self._cv:
            ts = list(self._event_times)
        return [b - a for a, b in zip(ts, ts[1:])]


class OnlineLLM:
    """Submit-while-running front end over
    :class:`repro_torch.serving.llm.LLM`.

        online = OnlineLLM("yi-9b", config=EngineConfig(prefix_cache=True),
                           device="cpu")
        s1 = online.submit(prompt_a)            # joins the live loop
        s2 = online.submit(prompt_b)            # ... at any time
        for ev in s1:                           # tokens per tick
            print(ev.token, ev.finished)
        out = s2.result()                       # drain to a RequestOutput

    Pass ``llm=`` to wrap an existing engine.  ``submit`` may be called
    from any thread; engine steps are serialised by a lock."""

    def __init__(self, model=None, *,
                 config: Optional[EngineConfig] = None, params=None,
                 rt=None, reduced: bool = True, device=None,
                 llm: Optional[LLM] = None):
        if llm is None:
            if model is None:
                raise ValueError("OnlineLLM needs a model (arch name / "
                                 "ModelConfig) or an existing llm=")
            llm = LLM(model, config=config, params=params, rt=rt,
                      reduced=reduced, device=device)
        self.llm = llm
        self.engine = llm.engine
        self._inbox: deque = deque()            # (Request, RequestStream)
        self._streams: Dict[int, RequestStream] = {}
        self._delivered: Dict[int, int] = {}
        self._lock = threading.Lock()           # inbox + stream registry
        self._step_lock = threading.Lock()      # serialises engine steps
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._error: Optional[BaseException] = None

    # -- submission --------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               sampling: Union[SamplingParams, None] = None
               ) -> RequestStream:
        """Enqueue one prompt into the live loop; returns its stream.
        Request ids follow submission order (the counter of
        ``LLM.generate``), so an arrival order reproduces the offline
        streams of the same ids."""
        with self._lock:
            req = self.llm._make_requests(
                [prompt], sampling if sampling is None else [sampling])[0]
            stream = RequestStream(self, req.request_id, req.prompt)
            self._inbox.append((req, stream))
            self._streams[req.request_id] = stream
            self._delivered[req.request_id] = 0
        self._wake.set()
        return stream

    # -- pump --------------------------------------------------------------

    def _engine_stream(self):
        return self.engine.stream_context()

    def step(self) -> bool:
        """One pump iteration: admit queued submissions, advance the engine
        one tick on its own stream, deliver the new tokens.  True while any
        work remains."""
        self._raise_pump_error()
        with self._step_lock, self._engine_stream():
            self._drain_inbox()
            alive = self.engine.step()
            self._dispatch()
        with self._lock:
            return alive or bool(self._inbox)

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Cooperative drain (no thread): step until nothing is pending.
        Returns the number of steps taken."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return steps

    def _drain_inbox(self) -> None:
        with self._lock:
            items = list(self._inbox)
            self._inbox.clear()
        rec = self.engine.recorder
        for req, stream in items:
            stream.seq = self.engine.submit([req])[0]
            if rec is not None:
                # the stream's own submit stamp, the float its ttft_s
                # subtracts, so the trace's TTFT equals the stream's
                # bitwise
                rec.request_stream_submit(req.request_id,
                                          stream.submit_time)

    def _dispatch(self) -> None:
        now = time.perf_counter()
        rec = self.engine.recorder
        with self._lock:
            live = list(self._streams.items())
        done: List[int] = []
        for rid, stream in live:
            seq = stream.seq
            if seq is None:
                continue
            n = len(seq.generated)
            d = self._delivered[rid]
            if d >= n:
                continue
            if rec is not None:
                # every event pushed this tick carries the same ``now``
                # stamp, so recording it once a request keeps the trace's
                # delivery times bitwise equal to the stream's
                rec.request_delivery(rid, now, n - d)
            fin = seq.is_done()
            reason = seq.finish_reason()
            while d < n:
                last = fin and d == n - 1
                stream._push(StreamEvent(
                    request_id=rid, index=d, token=seq.generated[d],
                    time=now, finished=last,
                    finish_reason=reason.value if last and reason else None))
                d += 1
            self._delivered[rid] = d
            if fin:
                done.append(rid)
        if done:
            with self._lock:
                for rid in done:
                    self._streams.pop(rid, None)
                    self._delivered.pop(rid, None)

    def _raise_pump_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("the online pump stopped on an engine "
                               "error") from self._error

    # -- threaded pump -----------------------------------------------------

    def start(self) -> "OnlineLLM":
        """Launch the background pump thread; consumers then wait for
        delivery instead of stepping the engine themselves."""
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._pump, name="online-pump", daemon=True)
            self._thread.start()
        return self

    def _pump(self) -> None:
        try:
            while not self._stop:
                if not self.step():
                    # idle: sleep until a submit wakes us (a short timeout
                    # keeps close() prompt without a wake)
                    self._wake.clear()
                    self._wake.wait(timeout=0.05)
        except Exception as e:          # handed to every consumer
            self._error = e
            with self._lock:
                streams = list(self._streams.values())
            for stream in streams:
                stream._wake()

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the pump thread (nothing to do in cooperative mode).
        Returns True when the thread ended within ``timeout``."""
        self._stop = True
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is None:
            return True
        thread.join(timeout=timeout)
        return not thread.is_alive()

    def __enter__(self) -> "OnlineLLM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        return self.engine.throughput_report()
