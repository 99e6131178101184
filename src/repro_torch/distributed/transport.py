"""Networked stage transport: the per-link seam between pipeline stages
(own copy of ``repro.distributed.transport``, numpy only).

DeServe's headline claim (6.7x–12.6x over baselines *in high-latency
networks*) lives or dies on what happens at the stage boundary: every
engine tick, the shift-register entries of both planes — decode
microbatches and prefill chunks — cross one inter-stage link each.  The
port's ``PipelinedBackend`` issues the stages in turn from one process,
each on its own device (the JAX package runs them inside one
``shard_map``), with boundaries that cost a card-to-card copy at most, so
this module makes the link a first-class,
*pluggable* object:

``InProcessTransport``
    Zero-cost links: the next stage reads the activation where the last
    one left it, the link costs nothing, no clock is kept.

``SimulatedLinkTransport``
    Per-link one-way latency + bandwidth + deterministic jitter applied
    to the activation payload crossing each boundary, accounted on a
    **virtual clock** — the computation is untouched (outputs stay
    bit-identical to ``InProcessTransport``), but every stage carries a
    virtual timeline: a stage's tick starts when both its previous tick
    finished *and* its input activation arrived over the link.  The
    latency-curve measurement reads throughput off this clock, so a 64 ms
    WAN run does not wait 64 ms a link.

``CompressedTransport``
    Wire-byte pricing for activation compression: wraps another
    transport and re-prices each payload through the int8 codec of
    :mod:`repro_torch.distributed.compression` (or top-k's byte formula)
    before the link sees it.  Under ``EngineConfig(wire_dtype="int8")``
    the ticks really do pass the per-row packed int8 payload between
    stages and the backend wraps its transport here so the books match
    the wire exactly; without the codec (or with top-k, which has no
    codec in the tick) it is what-if accounting.

``DeploymentPlan``
    Registry-driven deployment: turns a ``framework.registry.match``
    result (stage→machine assignment + the pairwise region latency
    matrix) into per-link ``LinkSpec``s, a ready-made transport, and the
    planner input (``max_link_latency``) that ``EngineConfig.plan``
    consumes instead of a scalar latency guess.

The timing model mirrors §4.3's ring: stage ``s`` sends its output over
link ``s → (s+1) mod N_S`` after each tick; the last link doubles as the
paper's *return* link — a drained microbatch's token ids must travel it
before the engine can re-inject that microbatch, which is exactly the
dependency that makes the round-flush schedule pay ``(N_S+N_B−1)(T_S+L)``
per token round while the circular schedule hides the latency entirely
once ``N_B ≥ N_S·(T_S+L)/T_S``.

A flight recorder (``set_recorder``, :mod:`repro_torch.obs`) is booked
at the exact sites where the books accumulate, gated on ``recorder is
not None``, so its ledger reconciles with ``stats()`` bitwise.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.distributed.compression import int8_wire_bytes
from repro_torch.framework.registry import region_latency


# ---------------------------------------------------------------------------
# Links and the virtual clock
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkSpec:
    """One directed inter-stage link: fixed one-way latency plus a
    bandwidth term per payload byte plus optional uniform jitter."""
    latency_s: float = 0.0
    bandwidth_bps: float = 0.0        # bytes/second; 0 = infinite
    jitter_s: float = 0.0             # max extra delay, drawn per send

    def __post_init__(self):
        if self.latency_s < 0 or self.bandwidth_bps < 0 or self.jitter_s < 0:
            raise ValueError(f"link parameters must be >= 0, got {self}")

    def delay(self, nbytes: int, rng: Optional[np.random.RandomState] = None
              ) -> float:
        d = self.latency_s
        if self.bandwidth_bps:
            d += nbytes / self.bandwidth_bps
        if self.jitter_s and rng is not None:
            d += float(rng.uniform(0.0, self.jitter_s))
        return d


class VirtualClock:
    """Monotonic simulated time — advanced by transport ticks, never by
    wall time, so WAN-scale latencies cost nothing to test."""

    def __init__(self):
        self.now = 0.0

    def advance_to(self, t: float) -> None:
        if t > self.now:
            self.now = t


@dataclass
class TickObs:
    """What one transport tick observed: per-stage link-induced stall
    seconds (what the resilience slice's straggler mitigation reads), the
    virtual completion time of the
    draining stage (0.0 when the last stage was a bubble), and the
    virtual time at which the drained payload's *return* trip lands back
    at the injector (the engine keys re-injection readiness off it)."""
    stalls: np.ndarray
    drain_done: float = 0.0
    return_ready: float = 0.0


# ---------------------------------------------------------------------------
# Transport interface
# ---------------------------------------------------------------------------


class Transport(abc.ABC):
    """Inter-stage link seam.  One instance serves one backend; ``tick``
    is called once per plane tick (decode and prefill both) with the
    stages' occupancy and the payload size crossing each boundary."""

    name: str = "abstract"
    recorder = None         # repro_torch.obs.trace.TraceRecorder, or None

    def set_recorder(self, recorder) -> "Transport":
        """Attach a flight recorder (``repro_torch.obs.trace.TraceRecorder``).
        Recording transports log link sends and per-tick stalls at the
        exact sites where their books accumulate, so the recorded ledger
        reconciles bitwise with ``stats()``.  The no-op paths keep the
        reference but record nothing (no books, no clock)."""
        self.recorder = recorder
        return self

    @abc.abstractmethod
    def bind(self, n_stages: int) -> "Transport":
        """Attach to a pipe of ``n_stages`` stages (validates link count,
        sizes the timelines).  Returns self for chaining."""

    @abc.abstractmethod
    def tick(self, occupied: Sequence[bool], nbytes: int,
             compute_s: Sequence[float], inject_t: float = 0.0,
             plane: str = "decode") -> TickObs:
        """Account one pipe tick.  ``occupied[s]`` — stage ``s`` held a
        real entry (bubbles neither compute nor send); ``nbytes`` — the
        activation payload each occupied stage ships downstream;
        ``compute_s[s]`` — stage compute seconds this tick;
        ``inject_t`` — earliest virtual time the entry injected at stage
        0 was available (its previous drain's return arrival);
        ``plane`` — which shift register is advancing ("decode" /
        "prefill"): the stage timelines are shared (one device per
        stage), but in-flight messages are per plane."""

    def for_stages(self, n_stages: int) -> "Transport":
        """A transport for a resized pipe (reshard): same link policy,
        fresh timelines.  Default: rebind in place."""
        return self.bind(n_stages)

    def stats(self) -> Dict:
        """Accounting snapshot for reports (empty on the no-op path)."""
        return {}

    def audit(self) -> None:
        """Strict-mode hook (``EngineConfig(strict=True)``): raise
        ``AssertionError`` if the transport's internal books are
        inconsistent.  The no-op paths keep no books to check."""


class InProcessTransport(Transport):
    """Zero-cost links — stages in one process hand the activation on
    directly.  Keeps no clock; ``tick`` returns all-zero observations."""

    name = "inprocess"

    def __init__(self):
        self._zeros = np.zeros((0,))

    def bind(self, n_stages: int) -> "InProcessTransport":
        self._zeros = np.zeros((n_stages,))
        return self

    def tick(self, occupied, nbytes, compute_s, inject_t=0.0,
             plane="decode") -> TickObs:
        return TickObs(stalls=self._zeros)


class SimulatedLinkTransport(Transport):
    """Per-link simulated WAN on a virtual clock.

    Each stage keeps a virtual timeline: its tick starts at
    ``max(previous tick done, input arrival)`` and runs for the stage
    compute time (``stage_time_s`` when set — deterministic benchmarks —
    else the measured per-stage share the backend passes in).  Occupied
    stages then ship ``nbytes`` over their downstream link; the arrival
    constrains the receiver's *next* tick.  Stage 0's input comes from
    the engine (``inject_t``), not the ring — the last link instead
    prices the drained payload's return trip (``TickObs.return_ready``),
    which is the §4.3 re-injection dependency.
    """

    name = "simulated"

    def __init__(self, links: Sequence[LinkSpec], *,
                 stage_time_s: Optional[float] = None, seed: int = 0,
                 return_bytes: int = 64):
        self.links: List[LinkSpec] = list(links)
        if not self.links:
            raise ValueError("SimulatedLinkTransport needs >= 1 link")
        self.stage_time_s = stage_time_s
        self.seed = seed
        self.return_bytes = return_bytes  # token ids, not activations
        self.clock = VirtualClock()
        self._rng = np.random.RandomState(seed)
        self._jittery = any(l.jitter_s for l in self.links)
        self._done: Optional[np.ndarray] = None     # per-stage tick-done t
                                                    # (shared: one device
                                                    # serves both planes)
        self._arrival: Dict[str, np.ndarray] = {}   # plane -> next input
                                                    # arrival per stage
                                                    # (in-flight messages
                                                    # are per plane)
        self.wire_bytes = 0
        self.sends = 0
        self.stall_s = 0.0

    @classmethod
    def uniform(cls, n_stages: int, latency_s: float, *,
                bandwidth_bps: float = 0.0, jitter_s: float = 0.0,
                **kw) -> "SimulatedLinkTransport":
        return cls([LinkSpec(latency_s, bandwidth_bps, jitter_s)
                    for _ in range(n_stages)], **kw).bind(n_stages)

    def bind(self, n_stages: int) -> "SimulatedLinkTransport":
        if len(self.links) != n_stages:
            raise ValueError(
                f"transport has {len(self.links)} link(s) but the pipe has "
                f"{n_stages} stage(s) — a ring needs one link per stage "
                "(use for_stages() to retarget after a reshard)")
        if self._done is None or self._done.shape[0] != n_stages:
            self._done = np.zeros((n_stages,))
            self._arrival = {}
        return self

    def for_stages(self, n_stages: int) -> "SimulatedLinkTransport":
        if n_stages == len(self.links):
            links = self.links
        else:
            # a reshard changed the ring size: keep the conservative
            # envelope — every link as slow as the slowest old one
            worst = max(self.links, key=lambda l: l.latency_s)
            links = [worst] * n_stages
        fresh = SimulatedLinkTransport(
            links, stage_time_s=self.stage_time_s, seed=self.seed,
            return_bytes=self.return_bytes).bind(n_stages)
        # accounting continuity across the rebuild (the recorder rides
        # along: a reshard must not cut the flight recording)
        fresh.clock.now = self.clock.now
        fresh.wire_bytes, fresh.sends = self.wire_bytes, self.sends
        fresh.stall_s = self.stall_s
        fresh.recorder = self.recorder
        return fresh

    def tick(self, occupied, nbytes, compute_s, inject_t=0.0,
             plane="decode") -> TickObs:
        n = len(self.links)
        assert self._done is not None, "tick() before bind()"
        rec = self.recorder
        occ = np.asarray(occupied, bool)
        stalls = np.zeros((n,))
        done = self._done
        arr = self._arrival.get(plane)
        arr = np.zeros((n,)) if arr is None else arr.copy()
        if occ[0]:
            arr[0] = max(arr[0], inject_t)
        new_arrival = np.zeros((n,))
        rng = self._rng if self._jittery else None
        for s in range(n):
            if not occ[s]:
                continue
            ts = self.stage_time_s if self.stage_time_s is not None \
                else float(compute_s[s])
            start = max(done[s], arr[s])
            stalls[s] = max(0.0, arr[s] - done[s])
            done[s] = start + ts
            if rec is not None:
                rec.stage_busy(plane, s, float(start), float(done[s]))
            if s != n - 1:                  # ship downstream for next tick
                t_arr = done[s] + self.links[s].delay(nbytes, rng)
                new_arrival[s + 1] = t_arr
                self.wire_bytes += nbytes
                self.sends += 1
                if rec is not None:         # the ledger event: exactly the
                    rec.link_send(plane, s, nbytes,  # bytes booked above
                                  float(done[s]), float(t_arr))
        # stage 0's next input comes from the engine, so the ring's last
        # link carries the drained *return* payload instead
        drain_done = float(done[n - 1]) if occ[n - 1] else 0.0
        return_ready = 0.0
        if occ[n - 1]:
            return_ready = drain_done + self.links[n - 1].delay(
                self.return_bytes, rng)
            self.wire_bytes += self.return_bytes
            self.sends += 1
            if rec is not None:
                rec.link_send(plane, n - 1, self.return_bytes,
                              drain_done, return_ready, return_trip=True)
        self._arrival[plane] = new_arrival
        tick_stall = float(stalls.sum())
        self.stall_s += tick_stall
        if occ.any():
            self.clock.advance_to(float(done[occ].max()))
        if rec is not None:
            # the same float the book accumulated, one entry per tick in
            # call order: a left-to-right sum reproduces stall_s bitwise
            rec.tick_stall(plane, tick_stall, self.clock.now)
        return TickObs(stalls=stalls, drain_done=drain_done,
                       return_ready=return_ready)

    def stats(self) -> Dict:
        return {
            "transport": self.name,
            "virtual_time_s": self.clock.now,
            "wire_bytes": int(self.wire_bytes),
            "link_sends": int(self.sends),
            "link_stall_s": float(self.stall_s),
            "max_link_latency_s": max(l.latency_s for l in self.links),
        }

    def audit(self) -> None:
        books = {"virtual_time_s": self.clock.now,
                 "wire_bytes": self.wire_bytes, "link_sends": self.sends,
                 "link_stall_s": self.stall_s}
        for k, v in books.items():
            assert np.isfinite(v) and v >= 0, \
                f"transport book {k}={v!r} is negative or non-finite"
        assert self.sends == 0 or self.wire_bytes > 0, \
            f"{self.sends} link send(s) accounted but zero wire bytes"
        if self._done is not None and self._done.size:
            assert np.isfinite(self._done).all() and \
                (self._done >= 0).all(), \
                f"per-stage timelines corrupt: {self._done!r}"
            assert self.clock.now + 1e-9 >= float(self._done.max()), \
                (f"virtual clock {self.clock.now} is behind a stage "
                 f"timeline ({float(self._done.max())}) — advance_to was "
                 "skipped on some tick")
        for plane, arr in self._arrival.items():
            assert np.isfinite(arr).all() and (arr >= 0).all(), \
                f"{plane} arrival timeline corrupt: {arr!r}"


class CompressedTransport(Transport):
    """Activation wire-byte pricing through the codecs of
    :mod:`repro.distributed.compression`: every payload is re-priced as
    int8- or top-k-compressed before the wrapped link carries it.

    With ``EngineConfig(wire_dtype="int8")`` the pipelined backend wraps
    its transport in this class automatically (setting ``elem_bytes`` to
    the compute dtype and ``row_elems`` to ``d_model``), and ``_wire``
    then computes exactly the bytes the ticks pass on: the per-row packed
    payload of ``int8_compress_rows`` — 1 B/element plus one f32 scale
    per row.  Used standalone on an uncompressed run
    (``wire_dtype="fp32"``), it is what-if accounting: the ratio is the
    headroom the codec would buy.  Top-k has no codec in the ticks and is
    always accounting-only."""

    name = "compressed"

    def __init__(self, inner: Transport, *, method: str = "int8",
                 topk_frac: float = 0.01, elem_bytes: int = 4,
                 row_elems: int = 0):
        if method not in ("int8", "topk"):
            raise ValueError(f"method must be 'int8'|'topk', got {method!r}")
        self.inner = inner
        self.method = method
        self.topk_frac = topk_frac
        self.elem_bytes = elem_bytes
        self.row_elems = row_elems      # elements per scale row (d_model);
                                        # 0 = one scale per payload
        self.raw_bytes = 0
        self._wire_cache: Dict[int, int] = {}

    def _wire(self, nbytes: int) -> int:
        w = self._wire_cache.get(nbytes)
        if w is None:
            n_elems = max(1, nbytes // self.elem_bytes)
            if self.method == "int8":
                n_rows = max(1, n_elems // self.row_elems) \
                    if self.row_elems else 1
                w = int8_wire_bytes(n_elems, n_rows)
            else:
                w = max(1, int(n_elems * self.topk_frac)) * 8
            self._wire_cache[nbytes] = w
        return w

    def set_recorder(self, recorder) -> "CompressedTransport":
        # the inner transport accumulates the books, so the inner
        # transport records — the ledger then carries the *re-priced*
        # wire bytes, exactly what the books accumulate
        self.inner.set_recorder(recorder)
        self.recorder = recorder
        return self

    def bind(self, n_stages: int) -> "CompressedTransport":
        self.inner.bind(n_stages)
        return self

    def for_stages(self, n_stages: int) -> "CompressedTransport":
        fresh = CompressedTransport(self.inner.for_stages(n_stages),
                                    method=self.method,
                                    topk_frac=self.topk_frac,
                                    elem_bytes=self.elem_bytes,
                                    row_elems=self.row_elems)
        fresh.raw_bytes = self.raw_bytes
        fresh.recorder = self.recorder
        return fresh

    def tick(self, occupied, nbytes, compute_s, inject_t=0.0,
             plane="decode") -> TickObs:
        self.raw_bytes += nbytes * int(np.count_nonzero(
            np.asarray(occupied, bool)[:-1]))
        return self.inner.tick(occupied, self._wire(nbytes), compute_s,
                               inject_t, plane)

    @property
    def clock(self):
        return getattr(self.inner, "clock", None)

    def stats(self) -> Dict:
        st = dict(self.inner.stats())
        st["transport"] = f"{self.name}[{self.method}]>" \
                          f"{st.get('transport', self.inner.name)}"
        st["raw_bytes"] = int(self.raw_bytes)
        wire = st.get("wire_bytes", 0)
        if wire:
            st["compression_ratio"] = self.raw_bytes / wire
        return st

    def audit(self) -> None:
        assert self.raw_bytes >= 0, \
            f"raw_bytes={self.raw_bytes} went negative"
        for raw, wire in self._wire_cache.items():
            assert wire > 0, f"codec priced {raw}B payload at {wire}B"
            if self.method == "int8" and raw > 4 * self.elem_bytes * \
                    max(1, self.row_elems):
                assert wire < raw, \
                    (f"int8 codec inflated a {raw}B payload to {wire}B — "
                     "elem_bytes/row_elems are mis-tuned for the wire")
        self.inner.audit()


# ---------------------------------------------------------------------------
# Deployment plans — registry output -> links + planner input
# ---------------------------------------------------------------------------


@dataclass
class DeploymentPlan:
    """A concrete stage→machine placement with its latency geometry.

    ``stages`` are display labels (miner names or regions), ``regions``
    the per-stage region used for latency lookup, and ``latency_matrix``
    the full pairwise one-way matrix in seconds (symmetric).  The ring
    link ``s → (s+1) mod N_S`` inherits the matrix entry of its two
    endpoint stages; ``max_link_latency`` is what the §4.3 planner
    consumes (``EngineConfig.plan(deployment=...)``) — the slowest link
    sets the bubble budget."""

    stages: List[str]
    regions: List[str]
    latency_matrix: np.ndarray          # (n, n) seconds, one-way
    bandwidth_bps: float = 0.0
    jitter_s: float = 0.0
    machines: Optional[list] = None     # MachineSpec refs when registry-built
    task: Optional[object] = None

    def __post_init__(self):
        self.latency_matrix = np.asarray(self.latency_matrix, float)
        n = len(self.stages)
        if len(self.regions) != n or self.latency_matrix.shape != (n, n):
            raise ValueError(
                f"inconsistent plan: {n} stage(s), {len(self.regions)} "
                f"region(s), latency matrix {self.latency_matrix.shape}")

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def link_latencies(self) -> List[float]:
        """One-way latency of each ring link ``s → (s+1) mod N_S``."""
        n = self.n_stages
        return [float(self.latency_matrix[s, (s + 1) % n])
                for s in range(n)]

    @property
    def link_specs(self) -> List[LinkSpec]:
        return [LinkSpec(lat, self.bandwidth_bps, self.jitter_s)
                for lat in self.link_latencies]

    @property
    def max_link_latency(self) -> float:
        return max(self.link_latencies)

    @property
    def worst_link(self) -> LinkSpec:
        """The slowest ring link (highest latency; bandwidth/jitter are
        plan-wide) — what `EngineConfig.plan` sizes the prefill chunk
        against: the thinnest pipe bounds every chunk's wire time."""
        return max(self.link_specs, key=lambda l: l.latency_s)

    @property
    def max_pairwise_latency(self) -> float:
        n = self.n_stages
        if n == 1:
            return float(self.latency_matrix[0, 0])
        iu = np.triu_indices(n, k=1)
        return float(self.latency_matrix[iu].max())

    def transport(self, *, stage_time_s: Optional[float] = None,
                  seed: int = 0, compress: Optional[str] = None,
                  topk_frac: float = 0.01) -> Transport:
        """The per-link :class:`SimulatedLinkTransport` this plan implies
        (optionally wrapped in wire-byte :class:`CompressedTransport`)."""
        t: Transport = SimulatedLinkTransport(
            self.link_specs, stage_time_s=stage_time_s,
            seed=seed).bind(self.n_stages)
        if compress:
            t = CompressedTransport(t, method=compress, topk_frac=topk_frac)
        return t

    # -- stage placement ----------------------------------------------------

    def placement_cost(self, order: Sequence[int],
                       stage_weights: Optional[Sequence[float]] = None
                       ) -> float:
        """Cost of visiting the machines in ``order`` (a ring): each
        link's latency weighted by the mean compute weight of its two
        endpoint stages —

            Σ_s  L(order[s] → order[s+1]) · (w[s] + w[s+1]) / 2

        With uniform weights this is exactly the ring latency sum that
        enters the §4.3 round trip (``plan_schedule``'s ``Σ L_i``), so
        minimising it is the shortest-Hamiltonian-cycle placement; with
        heterogeneous weights the slowest links are pushed to border the
        lightest stages (a stall behind a slow link costs less where
        there is less compute to starve)."""
        n = self.n_stages
        w = [1.0] * n if stage_weights is None else \
            [float(x) for x in stage_weights]
        if len(w) != n:
            raise ValueError(f"{len(w)} stage weight(s) for {n} stage(s)")
        cost = 0.0
        for s in range(n):
            a, b = order[s], order[(s + 1) % n]
            cost += float(self.latency_matrix[a, b]) * \
                (w[s] + w[(s + 1) % n]) / 2.0
        return cost

    def place_stages(self, stage_weights: Optional[Sequence[float]] = None
                     ) -> "DeploymentPlan":
        """The stage-*placement* pass: reorder the machines so the ring
        pays the least for its geography (see :meth:`placement_cost`).

        The registry's match order is arbitrary with respect to the
        ring; this picks the cheapest cycle instead — exhaustively for
        small rings (≤ 8 stages, rotations deduped by anchoring stage
        0), greedily (cheapest-next-hop) beyond.  Returns a new plan
        with stages/regions/machines and the latency matrix permuted
        consistently; the original is untouched."""
        import itertools
        n = self.n_stages
        if n <= 2:
            return self
        if n <= 8:
            best = min(
                ((0,) + rest for rest in
                 itertools.permutations(range(1, n))),
                key=lambda o: self.placement_cost(o, stage_weights))
        else:
            remaining = set(range(1, n))
            best_l = [0]
            while remaining:
                cur = best_l[-1]
                nxt = min(remaining,
                          key=lambda j: float(self.latency_matrix[cur, j]))
                best_l.append(nxt)
                remaining.discard(nxt)
            best = tuple(best_l)
        return self._reordered(best)

    def _reordered(self, order: Sequence[int]) -> "DeploymentPlan":
        idx = list(order)
        mat = self.latency_matrix[np.ix_(idx, idx)]
        return DeploymentPlan(
            stages=[self.stages[i] for i in idx],
            regions=[self.regions[i] for i in idx],
            latency_matrix=mat, bandwidth_bps=self.bandwidth_bps,
            jitter_s=self.jitter_s,
            machines=[self.machines[i] for i in idx]
            if self.machines is not None else None,
            task=self.task)

    def describe(self) -> str:
        lines = [f"deployment: {self.n_stages} stage(s)"]
        for s, (label, reg, lat) in enumerate(
                zip(self.stages, self.regions, self.link_latencies)):
            lines.append(f"  stage {s}: {label} [{reg}] --"
                         f"{lat * 1000:.0f}ms--> stage "
                         f"{(s + 1) % self.n_stages}")
        lines.append(f"  max link latency: "
                     f"{self.max_link_latency * 1000:.0f}ms "
                     "(planner input)")
        return "\n".join(lines)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_regions(cls, regions: Sequence[str], *,
                     bandwidth_bps: float = 0.0,
                     jitter_s: float = 0.0) -> "DeploymentPlan":
        """One stage per entry, latencies from the registry's region
        table (``framework.registry.region_latency``)."""
        regions = list(regions)
        n = len(regions)
        mat = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                mat[i, j] = region_latency(regions[i], regions[j])
        return cls(stages=list(regions), regions=regions,
                   latency_matrix=mat, bandwidth_bps=bandwidth_bps,
                   jitter_s=jitter_s)

    @classmethod
    def from_match(cls, match, *, bandwidth_bps: float = 0.0,
                   jitter_s: float = 0.0) -> "DeploymentPlan":
        """Registry-driven plan: the ``framework.registry.match`` result's
        machine order *is* the stage order (inter-layer partitioning,
        §2.3), latencies from each machine pair's regions."""
        machines = list(match.machines)
        regions = [m.region for m in machines]
        n = len(machines)
        mat = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                mat[i, j] = region_latency(regions[i], regions[j])
        return cls(stages=[f"{m.miner}#{m.machine_id}" for m in machines],
                   regions=regions, latency_matrix=mat,
                   bandwidth_bps=bandwidth_bps, jitter_s=jitter_s,
                   machines=machines, task=match.task)

    @classmethod
    def uniform(cls, n_stages: int, latency_s: float, *,
                bandwidth_bps: float = 0.0,
                jitter_s: float = 0.0) -> "DeploymentPlan":
        mat = np.full((n_stages, n_stages), latency_s)
        return cls(stages=[f"stage{s}" for s in range(n_stages)],
                   regions=["uniform"] * n_stages, latency_matrix=mat,
                   bandwidth_bps=bandwidth_bps, jitter_s=jitter_s)


def make_transport(kind, n_stages: int, **kw) -> Transport:
    """Factory: ``kind`` is None / "inprocess" (zero-cost), a float
    (uniform simulated latency), a :class:`DeploymentPlan`, or an already
    constructed :class:`Transport` (bound and passed through)."""
    if kind is None or kind == "inprocess":
        return InProcessTransport().bind(n_stages)
    if isinstance(kind, Transport):
        return kind.bind(n_stages)
    if isinstance(kind, DeploymentPlan):
        return kind.transport(**kw).bind(n_stages)
    if isinstance(kind, (int, float)):
        return SimulatedLinkTransport.uniform(n_stages, float(kind), **kw)
    raise ValueError(f"unknown transport {kind!r} (want None, 'inprocess', "
                     "a latency in seconds, a DeploymentPlan, or a "
                     "Transport instance)")
