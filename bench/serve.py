"""Drive one cell through the port's served path.

``Runner`` builds ``repro_torch``'s ``OfflineEngine`` through
``EngineConfig.build`` from the cell's files, with the benchmark's seeded
weights, and keeps a closed loop with a standing queue: after every
``OfflineEngine.step`` the queue is topped up to the mix's backlog.  It
warms up until every request of the first batch-full has been given a
slot (every step shape the cell uses is captured by then), opens the
window after a ``torch.cuda.synchronize()``, steps until ``seconds`` have
passed, and closes it with another.  A traced run then steps on for a short slice
under ``torch.profiler``.

The benchmark's spans and counters come from its own wrappers around
``OfflineEngine.step`` and the backend's ``decode`` and ``prefill_step``
(host clock, the rows and lengths they were handed); nothing inside the
program is instrumented.  Each token is stamped with the host clock when
the harness first sees it: tokens from a prefill chunk when the decode
call of their step starts, tokens from a decode tick when the step ends.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import traffic as traffic_lib
from bench import weights as weights_lib

WARMUP_STEP_LIMIT = 20000


def _field(cfg, name: str):
    """A ModelConfig field by name; a dotted name (``a.b``) reads a field
    of a nested one (None where a level is None)."""
    for part in name.split("."):
        cfg = None if cfg is None else getattr(cfg, part)
    return cfg


def program_config(arch, conf: dict):
    """The port's ModelConfig for a configuration file: the registered arch
    with the file's ``program.set`` fields, checked against the file's
    published keys that ``arch`` maps to fields (``CONFIG_FIELDS``) and
    the fields its reference must find (``PROGRAM_FIELDS``).  ``arch`` is
    the configuration's module."""
    from repro_torch.config import get_arch

    prog = conf["program"]
    cfg = dataclasses.replace(get_arch(prog["arch"]), **prog.get("set", {}))
    wrong = {}
    for key, field in arch.CONFIG_FIELDS.items():
        if key in conf and _field(cfg, field) != conf[key]:
            wrong[key] = (conf[key], _field(cfg, field))
    for field, want in arch.PROGRAM_FIELDS.items():
        if _field(cfg, field) != want:
            wrong[field] = (want, _field(cfg, field))
    if wrong:
        raise ValueError(f"{conf['name']}: the program's config differs "
                         f"from the file (file, program): {wrong}")
    return cfg


@dataclasses.dataclass
class Call:
    """One backend call the harness wrapped (host clock)."""
    t0: float
    t1: float
    rows: int           # rows of the call's shape
    live: int           # rows doing real work (decode: live rows;
                        # prefill: real tokens)
    ctx: int            # sum over the real tokens of the lengths attended
    kernel_toks: int    # decode: sum over every row of the paged kernel's
                        # lengths (what it reads, idle rows included)
    # each real row's first position and its real tokens, positions
    # offsets[i] .. offsets[i] + n_valid[i] - 1 (decode: a live row's
    # position, one token; prefill: the chunk's offsets and n_valid), so
    # that a reader can cap the lengths attended by a window
    offsets: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    n_valid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))


@dataclasses.dataclass
class Phase:
    """What the harness counted in one stretch of steps."""
    t0: float = 0.0
    t1: float = 0.0
    decode: List[Call] = dataclasses.field(default_factory=list)
    prefill: List[Call] = dataclasses.field(default_factory=list)
    steps: List[tuple] = dataclasses.field(default_factory=list)
    pages: List[float] = dataclasses.field(default_factory=list)
    gaps: List[float] = dataclasses.field(default_factory=list)
    stats0: dict = dataclasses.field(default_factory=dict)
    stats1: dict = dataclasses.field(default_factory=dict)
    captures0: int = 0
    captures1: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def delta(self, key: str) -> float:
        return self.stats1[key] - self.stats0[key]


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Runner:
    """One cell's engine, traffic and counters (see the module docstring)."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.models.common import Runtime
        from repro_torch.serving.kv_cache import PoolConfig
        from repro_torch.serving.llm import EngineConfig

        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        conf, eng = cell.config, cell.engine
        self.sizes = cell.arch.sizes(conf)
        self.cfg = program_config(cell.arch, conf)
        dtype = getattr(torch, conf["dtype"])
        self.params = weights_lib.make_params(cell.arch, conf, seed,
                                              self.device, dtype)
        rows = int(eng["rows"])
        mbs = int(eng.get("microbatches", 1))
        page = int(eng.get("page_size", 16))
        self.pages_seq = traffic_lib.pages_for(cell.traffic, page)
        self.pool = PoolConfig(page_size=page,
                               n_local_pages=rows * self.pages_seq + 1,
                               n_global_pages=0,
                               max_pages_per_seq=self.pages_seq)
        chunk = int(eng["prefill_chunk"])
        econf = EngineConfig(
            mb_size=rows // mbs, num_microbatches=mbs, pool=self.pool,
            offload=False, seed=self.seed % (1 << 63), prefill_chunk=chunk,
            max_prefill_tokens_per_tick=chunk * int(eng.get("prefill_rows",
                                                            1)),
            prefill_mode="chunked", backend=eng.get("backend", "local"),
            strict=False)
        self.rt = Runtime(param_dtype=dtype, compute_dtype=dtype)
        self.engine = econf.build(self.cfg, self.params, self.rt,
                                  self.device)
        self.rows = rows
        self.stream = traffic_lib.Stream(cell.traffic, seed,
                                         self.sizes["V"], rows)
        self.asked: Dict[int, traffic_lib.Req] = {}
        self.seen: Dict[int, tuple] = {}
        self.first: List = []       # the first batch-full's sequences
        self.phase: Optional[Phase] = None
        self.tracing = False
        self._wrap()

    # -- the wrappers -------------------------------------------------------

    def _span(self, name: str):
        if self.tracing:
            return torch.profiler.record_function(name)
        return nullcontext()

    def _wrap(self) -> None:
        backend = self.engine.backend
        decode, prefill_step = backend.decode, backend.prefill_step
        engine = self.engine

        def wrapped_decode(mb, tokens, cur_pos, samp, active=True):
            t0 = time.perf_counter()
            if self.phase is not None:
                self._stamp(t0)
            lo = mb * engine.mb_size
            live = engine.active[lo:lo + engine.mb_size].copy()
            pos = np.asarray(cur_pos, np.int64).copy()
            with self._span("bench.decode"):
                out = decode(mb, tokens, cur_pos, samp, active)
            if active and self.phase is not None:
                at = pos[live]
                self.phase.decode.append(Call(
                    t0, time.perf_counter(), len(pos), len(at),
                    int((at + 1).sum()), int((pos + 1).sum()), at,
                    np.ones_like(at)))
            return out

        def wrapped_prefill(chunk):
            if chunk is None:
                return prefill_step(chunk)
            t0 = time.perf_counter()
            with self._span("bench.prefill"):
                out = prefill_step(chunk)
            if self.phase is not None:
                n = np.array(chunk.n_valid, np.int64)
                o = np.array(chunk.offsets, np.int64)
                self.phase.prefill.append(Call(
                    t0, time.perf_counter(), chunk.tokens.shape[0],
                    int(n.sum()), int((n * o + n * (n + 1) // 2).sum()), 0,
                    o, n))
            return out

        backend.decode = wrapped_decode
        backend.prefill_step = wrapped_prefill

    # -- traffic --------------------------------------------------------------

    def top_up(self) -> None:
        from repro_torch.serving.request import Request, SamplingParams

        mix = self.cell.traffic
        want = self.stream.backlog() - len(self.engine.queue)
        reqs = []
        for _ in range(max(0, want)):
            r = self.stream.next()
            self.asked[r.index] = r
            sp = SamplingParams(
                temperature=0.0 if r.greedy else float(mix["temperature"]),
                top_k=0 if r.greedy else int(mix.get("top_k", 0)),
                top_p=1.0 if r.greedy else float(mix["top_p"]),
                max_new_tokens=r.max_new, eos_token=-1)
            reqs.append(Request(r.index, r.prompt.tolist(), sp))
        if reqs:
            seqs = self.engine.submit(reqs)
            self.first += [q for q in seqs
                           if q.request.request_id < self.rows]

    def _stamp(self, now: float) -> None:
        """Stamp the tokens that appeared since the last look; a gap is
        kept when both its tokens fell in the phase."""
        ph = self.phase
        for seq in self.engine.slots:
            if seq is None:
                continue
            rid = seq.request.request_id
            n = len(seq.generated)
            prev_n, prev_t = self.seen.get(rid, (0, None))
            if n > prev_n:
                if prev_t is not None and prev_t >= ph.t0:
                    ph.gaps.append(now - prev_t)
                    ph.gaps.extend([0.0] * (n - prev_n - 1))
                self.seen[rid] = (n, now)

    def _stats(self) -> dict:
        s = self.engine.stats
        return {"decode_tokens": s.decode_tokens,
                "prefill_tokens": s.prefill_tokens,
                "prefill_time_s": s.prefill_time_s}

    def _captures(self) -> int:
        return sum(self.engine.backend.graphs.captures.values())

    def capture_s(self) -> float:
        """Host seconds the backend spent warming up and capturing its
        graphs."""
        return self.engine.backend.graphs.capture_s

    def _pages_used(self) -> float:
        n = self.pool.n_local_pages - 1
        return (n - self.engine.alloc.free_local()) / n

    def devices(self):
        return list(dict.fromkeys(self.engine.backend.stage_devices))

    # -- the run -------------------------------------------------------------

    def warm_up(self) -> int:
        """Step until every request of the first batch-full has been
        given a slot; returns the steps."""
        from repro_torch.serving.request import Status

        self.top_up()
        steps = 0
        while any(q.status is Status.QUEUED for q in self.first):
            self.engine.step()
            self.top_up()
            steps += 1
            if steps > WARMUP_STEP_LIMIT:
                raise RuntimeError("the first batch-full was never admitted")
        _sync(self.devices())
        return steps

    def run_phase(self, seconds: float) -> Phase:
        """Step for ``seconds`` (then to the end of the step), between two
        synchronisations, counting."""
        devs = self.devices()
        _sync(devs)
        ph = self.phase = Phase(stats0=self._stats(),
                                captures0=self._captures())
        ph.t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            with self._span("bench.step"):
                self.engine.step()
            te = time.perf_counter()
            with self._span("bench.harness"):
                self._stamp(te)
                ph.steps.append((ts, te))
                ph.pages.append(self._pages_used())
                self.top_up()
            if te - ph.t0 >= seconds:
                break
        _sync(devs)
        ph.t1 = time.perf_counter()
        ph.stats1 = self._stats()
        ph.captures1 = self._captures()
        self.phase = None
        return ph

    def traced_phase(self, seconds: float, path: str):
        """``run_phase`` under ``torch.profiler``; returns the phase and
        the profiler's Chrome trace, written to ``path`` (the caller reads
        and removes it)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self.tracing = True
        try:
            with torch.profiler.record_function("bench.traced"):
                ph = self.run_phase(seconds)
        finally:
            self.tracing = False
            prof.stop()
        prof.export_chrome_trace(path)
        del prof
        return ph

    def finished_greedy(self) -> List[dict]:
        """Every finished greedy request: its prompt and served tokens, and
        how many tokens it asked for."""
        out = []
        for seq in self.engine.finished:
            if seq.sampling.temperature != 0.0:
                continue
            rid = seq.request.request_id
            out.append({"id": rid, "prompt": list(seq.request.prompt),
                        "tokens": list(seq.generated),
                        "asked": self.asked[rid].max_new})
        return out

    def short_finishes(self) -> int:
        """Finished requests that served fewer tokens than they asked."""
        return sum(1 for seq in self.engine.finished
                   if len(seq.generated) <
                   self.asked[seq.request.request_id].max_new)

    def attempted(self) -> int:
        return len(self.engine.finished) + sum(
            1 for s in self.engine.slots if s is not None)

    def memory_peak(self) -> int:
        return max(torch.cuda.max_memory_allocated(d)
                   for d in self.devices() if d.type == "cuda") \
            if self.device.type == "cuda" else 0

    def free_engine(self) -> None:
        """Drop the engine (its caches and graphs); the weights stay."""
        self.engine.backend.graphs.clear()
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def trace_path(root) -> str:
    """Where a traced run's profiler output goes: inside the checkout, at a
    fixed path, removed once read."""
    d = os.path.join(root, "build", "bench")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "trace.json")
