"""Elastic scaling, failure handling and straggler mitigation (own copy of
``repro.distributed.elastic``; pure host Python, no tensors).

Decentralised GPUs (paper Table 1: "intermittent" availability) make node
loss the common case.  This module holds the control-plane logic, pure,
deterministic and testable on the CPU:

  * :class:`ElasticPlanner` — given the live-device count, choose the
    largest legal mesh (data dim shrinks first, model dim preserved so TP
    sharding stays valid) and emit a resharding plan.
  * :class:`FailureDetector` — heartbeat bookkeeping with a configurable
    timeout; drives ``OfflineEngine.reshard``.  A device that misses the
    timeout and then beats again is a *flap* — recorded per device, never
    silently resurrected.
  * :class:`StragglerMitigator` — EWMA per-stage tick times; flags outliers
    and re-weights microbatch assignment (slow stage gets smaller
    microbatches) or recommends demotion to spare.
  * :class:`FaultPlan` — deterministic fault injection for tests and
    drills: drop (lose the microbatch at stage ``s`` at backend tick
    ``t``) or delay (synthetic straggling) events, consumed by the
    serving ``PipelinedBackend``.

The serving engine of the port consumes all four for mid-run recovery
(``repro_torch.serving.engine.OfflineEngine.reshard``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_used: int
    devices_spare: int

    @property
    def data(self) -> int:
        return self.shape[self.axes.index("data")]

    @property
    def model(self) -> int:
        return self.shape[self.axes.index("model")]


class ElasticPlanner:
    """Choose meshes as devices come and go.

    Invariants: the "model" axis is preserved (param TP sharding stays
    valid → only batch-dim resharding on resize, which is a cheap
    redistribution, not a weight reshuffle); "data" is the largest power of
    two that fits; the pod axis only exists while >= 2 full pods are live.
    """

    def __init__(self, model_parallel: int = 16, pod_size: int = 256):
        self.model_parallel = model_parallel
        self.pod_size = pod_size

    def plan(self, live_devices: int) -> MeshPlan:
        mp = self.model_parallel
        if live_devices < mp:
            raise RuntimeError(
                f"cannot serve: {live_devices} devices < model parallel {mp}")
        pods = live_devices // self.pod_size
        if pods >= 2:
            per_pod = self.pod_size
            data = self._pow2(per_pod // mp)
            used = pods * data * mp
            return MeshPlan(shape=(pods, data, mp),
                            axes=("pod", "data", "model"),
                            devices_used=used,
                            devices_spare=live_devices - used)
        data = self._pow2(live_devices // mp)
        used = data * mp
        return MeshPlan(shape=(data, mp), axes=("data", "model"),
                        devices_used=used,
                        devices_spare=live_devices - used)

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << max(0, n.bit_length() - 1)

    def resharding_plan(self, old: MeshPlan, new: MeshPlan) -> dict:
        """What must move when the mesh changes."""
        dp_changed = (old.data != new.data or
                      old.devices_used != new.devices_used)
        return {
            "model_axis_changed": old.model != new.model,
            "params_move": old.model != new.model,     # TP reshard = heavy
            "batch_reshard": dp_changed,               # cheap redistribution
            "restore_from_checkpoint": old.model != new.model,
            "old": old, "new": new,
        }


@dataclass
class Heartbeat:
    last_seen: float
    failures: int = 0                  # dead->live transitions (flaps)


class FailureDetector:
    """Heartbeat bookkeeping.  ``dead``/``live`` use a strict timeout
    (``now - last_seen == timeout`` is still live, so a boundary probe can
    never double-count a failure); a beat from a device that had already
    missed the timeout is a dead->live *flap* and increments its failure
    record instead of silently resurrecting it."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self._beats: Dict[int, Heartbeat] = {}

    def beat(self, device_id: int, now: float) -> None:
        hb = self._beats.get(device_id)
        if hb is None:
            self._beats[device_id] = Heartbeat(last_seen=now)
            return
        if now - hb.last_seen > self.timeout:
            hb.failures += 1           # resurrection: record the flap
        hb.last_seen = now

    def flap_count(self, device_id: Optional[int] = None) -> int:
        """Dead->live transitions for one device (0 if unseen), or summed
        across all devices when ``device_id`` is None."""
        if device_id is not None:
            hb = self._beats.get(device_id)
            return hb.failures if hb is not None else 0
        return sum(hb.failures for hb in self._beats.values())

    def dead(self, now: float) -> List[int]:
        return [d for d, hb in self._beats.items()
                if now - hb.last_seen > self.timeout]

    def live(self, now: float) -> List[int]:
        return [d for d, hb in self._beats.items()
                if now - hb.last_seen <= self.timeout]

    def should_restart(self, now: float, required: int) -> bool:
        return len(self.live(now)) < required


class StragglerMitigator:
    """EWMA stage-time tracking + microbatch re-weighting.

    The circular schedule (§4.3) is only bubble-free if every stage keeps
    pace; one slow stage sets the ring tick.  Mitigation: shrink the slow
    stage's share of per-microbatch work (fewer sequences routed to the
    microbatches it bottlenecks) or — beyond a threshold — recommend the
    planner demote the node and promote a spare.
    """

    def __init__(self, n_stages: int, alpha: float = 0.2,
                 slow_factor: float = 1.5, demote_factor: float = 3.0):
        self.n_stages = n_stages
        self.alpha = alpha
        self.slow_factor = slow_factor
        self.demote_factor = demote_factor
        self.ewma = [0.0] * n_stages

    def observe(self, stage: int, tick_time: float) -> None:
        cur = self.ewma[stage]
        self.ewma[stage] = tick_time if cur == 0.0 else (
            self.alpha * tick_time + (1 - self.alpha) * cur)

    def median(self) -> float:
        s = sorted(t for t in self.ewma if t > 0)
        return s[len(s) // 2] if s else 0.0

    def stragglers(self) -> List[int]:
        med = self.median()
        if med == 0:
            return []
        return [i for i, t in enumerate(self.ewma)
                if t > self.slow_factor * med]

    def demotions(self) -> List[int]:
        med = self.median()
        if med == 0:
            return []
        return [i for i, t in enumerate(self.ewma)
                if t > self.demote_factor * med]

    def microbatch_weights(self) -> List[float]:
        """Relative per-stage work shares ∝ 1/EWMA.  Observed stages are
        normalised to mean 1.0 *among themselves*; a cold stage (no
        observation yet, ewma == 0) gets exactly 1.0 — it must neither be
        penalised nor skew the normalisation.  Feed into the engine's
        per-tick admission budget (slow stage → lighter microbatches)."""
        med = self.median()
        if med == 0:
            return [1.0] * self.n_stages
        inv = [med / t if t > 0 else None for t in self.ewma]
        observed = [w for w in inv if w is not None]
        mean = sum(observed) / len(observed)
        return [1.0 if w is None else w / mean for w in inv]


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault: at backend tick ``tick`` of ``plane`` ("decode"
    or "prefill"), stage ``stage`` either *drops* (the microbatch/chunk at
    that stage is lost — never drains, its remaining cache writes never
    happen) or is *delayed* (the tick completes but the stage's observed
    time is inflated by ``delay_s`` — feeds straggler mitigation).  Tick
    indices are plane-local and count only ticks where the plane actually
    advanced (something was in flight)."""
    plane: str                         # "decode" | "prefill"
    tick: int
    stage: int
    kind: str = "drop"                 # "drop" | "delay"
    delay_s: float = 0.0

    def __post_init__(self):
        if self.plane not in ("decode", "prefill"):
            raise ValueError(f"plane must be 'decode'|'prefill', "
                             f"got {self.plane!r}")
        if self.kind not in ("drop", "delay"):
            raise ValueError(f"kind must be 'drop'|'delay', "
                             f"got {self.kind!r}")
        if self.tick < 0 or self.stage < 0:
            raise ValueError("tick and stage must be >= 0")


class FaultPlan:
    """A consumable schedule of :class:`FaultEvent`.  The serving
    ``PipelinedBackend`` calls :meth:`take` once per plane tick; consumed
    events move to ``triggered`` so tests can assert the plan fired."""

    def __init__(self, events=()):
        self.events: List[FaultEvent] = sorted(events,
                                               key=lambda e: e.tick)
        self.triggered: List[FaultEvent] = []

    def __bool__(self) -> bool:
        return bool(self.events)

    def take(self, plane: str, tick: int) -> List[FaultEvent]:
        hit = [e for e in self.events
               if e.plane == plane and e.tick == tick]
        if hit:
            self.events = [e for e in self.events if e not in hit]
            self.triggered.extend(hit)
        return hit

    def pending(self) -> int:
        return len(self.events)

    @classmethod
    def parse(cls, specs) -> "FaultPlan":
        """Build a plan from CLI specs: ``kind@plane:tick:stage[:delay_s]``
        e.g. ``drop@decode:12:1`` or ``delay@prefill:3:0:0.25``."""
        events = []
        for spec in specs:
            try:
                kind, rest = spec.split("@", 1)
                parts = rest.split(":")
                plane, tick, stage = parts[0], int(parts[1]), int(parts[2])
                delay = float(parts[3]) if len(parts) > 3 else 0.0
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad fault spec {spec!r} (want "
                    f"kind@plane:tick:stage[:delay_s], e.g. "
                    f"drop@decode:12:1): {e}") from e
            events.append(FaultEvent(plane=plane, tick=tick, stage=stage,
                                     kind=kind, delay_s=delay))
        return cls(events)
