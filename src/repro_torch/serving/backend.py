"""Execution backends for the offline serving engine (counterpart of
``repro.serving.backend``).

The engine owns the bookkeeping (queue, slots, page allocator, host page
table, positions); a backend owns the device caches and the compute:

  ``prefill_step(chunk)`` — advance the prefill plane one tick, optionally
        injecting a :class:`PrefillChunk` (a fixed-shape batch of
        prompt-token rows with their own page-table rows).  The local
        backend returns the chunk's :class:`PrefillResult` at once; the
        pipelined one routes it stage to stage and returns it ``N_S − 1``
        ticks later.  ``prefill_can_accept`` / ``prefill_pending`` expose
        the pipe's state;
  ``prefill(tokens, slot, last_index)`` — the exact-length path: run one
        whole (padded) prompt into ``slot`` through the whole model and
        return its last-position logits;
  ``reset_slot(slot)`` — clear a reassigned slot's ring positions and
        recurrent states;
  ``decode(mb, tokens, cur_pos, samp)`` — advance microbatch ``mb`` one
        token tick and return zero or more :class:`DecodeResult`; a result
        may be for an *earlier* microbatch (a pipe drains with latency),
        so the engine applies results by the microbatch they carry, and
        ``busy_microbatches`` / ``pending`` say which are in flight;
  ``set_page_table`` — push the engine's host table to the device.

A result whose work a stage fault dropped comes back with ``lost=True``:
nothing of it may be booked, and the engine injects the same work again.

Two implementations:

``LocalBackend``
    The single-device path: one model call per prefill chunk and one per
    microbatch decode tick, over an ``mb_size`` row view of the caches.

``PipelinedBackend``
    DeServe's §4.3 circular schedule as a persistent stepper over the
    ``N_S``-stage tick functions of :mod:`repro_torch.core.pipeline`.  Each
    engine tick injects one microbatch at stage 0 and advances every
    in-flight one a stage; the microbatch leaving the last stage drains
    through the epilogue and the sampler ``N_S − 1`` ticks after its
    injection.  Every stage crossing travels a transport
    (:mod:`repro_torch.distributed.transport`): zero-cost in process, or a
    simulated link on a virtual clock.  The stage is the unit of
    placement: stage ``s`` owns its layers' weights and caches, its
    offloader and its tick inputs on ``mesh[s]`` (``stage_devices``), and
    the activation moves to the next stage's device between ticks.  One
    process issues the stages in turn, each on its device's current
    stream; ``mesh=None`` puts every stage on the engine's device.

The pipelined backend also takes a
:class:`repro_torch.distributed.elastic.FaultPlan`: a ``drop`` at stage
``s`` empties the stage's shift-register entry before the tick, so the
stage is a bubble (it computes nothing and writes nothing) and the payload
comes back lost; a ``delay`` inflates the stage's observed seconds.  Each
tick's stage times (the tick's seconds over ``N_S``, plus the stage's
injected delay and link stall, for each stage that ran or was delayed)
wait in ``drain_stage_times`` for the engine's straggler mitigation, and
``export_offload_state`` / ``import_offload_state`` carry the offloaders'
host stores across a reshard to another stage count.

With offload (DeServe §4.2) a backend makes a microbatch's global pool
resident before every model call that may touch it: each residency
microbatch of a prefill chunk, an exact prefill into a slot that holds
global pages, and every decode tick.  The pipelined backend keeps one
:class:`repro_torch.core.offload.DoubleBufferOffloader` a stage, over that
stage's layers, and one for the epilogue when it holds paged layers.  Swap
copies go on the offloaders' copy streams; every model call, attention
kernels included, stays on the compute stream.

Where the JAX package jits its decode step (``_decode_jit``), its pipe
tick (``_tick_jit``), its prefill chunk (``_chunk_jit``), its pipe's
prefill tick (``_pf_tick_jit``) and its exact prefill (one
``_prefill_jits`` wrapper a bucketed length), a backend here captures
each step once as a CUDA graph and replays it (:mod:`repro_torch.serving.
step_graph`): the local backend one graph a decode microbatch and one for
its prefill chunk's shape, the pipelined backend one a (stage,
microbatch) and one a drained microbatch's epilogue and sampler for
decode (each in a greedy and a sampled variant where it samples), and
one a stage and one for the drain for prefill; both one a (bucketed
length, stage) for exact prefill, captured at the bucket's second call
(its first runs eagerly).  The host inputs go into static tensors the
backend owns, one packed int32 copy a device (a decode tick's tokens,
positions, top-k, and the float32 bits of temperature and top-p, the
Gumbel noise drawn into its own; a chunk's tokens, offsets, valid
counts, last indices and table rows; an exact prefill's slot, last
index and tokens), and the steps' outputs come back in static tensors
(tokens and log-probs, logits, each stage's activation); a prefill's
logits are copied out of theirs, so a result outlives the next replay.
The offloader's swaps, the noise draw, the fault plan, the transport and
the activation's hand-off between stages (``core.pipeline._wire``, or a
plain copy between an exact prefill's stages) stay outside the graphs,
between replays.  On a CPU device the same steps run eagerly;
``_decode_fn``, ``_chunk_fn`` and ``_prefill_fn`` are the eager steps
they are held against.  The JAX pipelined backend's sharding-layout
machinery (``_commit``, ``_probe_layout``, ``_cache_shardings``), which
keeps its jit caches steady, has nothing to do here.  The JAX backends'
``jit_entries`` seam (the strict auditor's jit cache probes) becomes
``graph_entries`` (each key's graph, captured once for the backend's
life) and ``kernel_libraries`` (the loaded kernel libraries, which must
not be built or loaded again mid-serve).

A flight recorder (``recorder=``, or ``set_recorder`` on a running
backend; :mod:`repro_torch.obs`) rides on the backend's offloaders and, on
the pipelined backend, on the outer transport; the pipelined backend
records each plane tick's wall window and stage occupancy (``pipe_tick``)
and each injected fault, from host values only.  Both backends record
where a call's host time goes, on the ``backend`` track, each span
starting where the last ended (``_lap``): a decode call's
``decode.inputs`` (the packed inputs and their copies), ``decode.noise``
(the sampled rows' Gumbel noise; ``rows`` drawn), ``decode.launch`` (the
residency checks and the replays) and ``decode.readout`` (until the
tokens are on the host, or the card is synchronised where a pipe tick
drains nothing); a prefill call's ``prefill.inputs``, ``prefill.launch``
and ``prefill.wait`` (the logits' copy and the synchronisation).  With no
recorder none of this takes a stamp.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import pipeline as PL
from repro_torch.core.offload import DoubleBufferOffloader
from repro_torch.distributed.transport import (CompressedTransport,
                                               InProcessTransport,
                                               make_transport)
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels import paged_attention as paged_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime, stage_device
from repro_torch.obs.trace import BACKEND_TRACK
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.step_graph import StepGraphs
from repro_torch.serving.sampler import (RowSampling, greedy, gumbel_noise,
                                         sample_batched, token_logprobs)


@dataclass
class DecodeResult:
    """One drained microbatch tick: ``tokens[i]`` is the next token for
    slot ``mb * mb_size + i`` (the engine decides which rows are live)."""
    mb: int
    tokens: np.ndarray                  # (mb_size,) int32
    logprobs: np.ndarray                # (mb_size,) f32, raw-logits logprob
    lost: bool = False                  # a stage fault dropped the tick:
                                        # book nothing, inject it again


@dataclass
class PrefillChunk:
    """One per-tick prefill work unit: up to R rows of C prompt tokens,
    shapes fixed by the engine (``prefill_rows`` x ``prefill_chunk``);
    padded rows carry ``n_valid == 0``."""
    tokens: np.ndarray                  # (R, C) int32
    offsets: np.ndarray                 # (R,) int32 tokens already prefilled
    n_valid: np.ndarray                 # (R,) int32 real tokens this chunk
    lasts: np.ndarray                   # (R,) int32 within-chunk index of the
                                        # final prompt token (-1: not final)
    tables: np.ndarray                  # (R, max_pages) int32 table rows
    seqs: list                          # engine-side SequenceState refs
    residency_mbs: tuple = ()           # microbatch ids (at most one per
                                        # global-pool parity) whose global
                                        # pool the chunk's rows write


@dataclass
class PrefillResult:
    """A finished prefill chunk: ``logits[i]`` are row ``i``'s
    last-position logits, meaningful only where ``chunk.lasts[i] >= 0``.
    They stay on the device (the engine samples first tokens there).  A
    lost chunk (a stage fault dropped it) has no logits."""
    chunk: PrefillChunk
    logits: Optional[torch.Tensor]      # (R, V) float32, on the device
    lost: bool = False


def _chunk_layout(rows: int, clen: int, n_pages: int, n_stages: int):
    """The packed int32 input of a prefill tick: ``(name, shape)`` of its
    pieces, in order; offsets, valid counts and table rows have one row a
    stage (one on the local backend), the last indices are the draining
    chunk's."""
    return [("tokens", (rows, clen)), ("offsets", (n_stages, rows)),
            ("n_valid", (n_stages, rows)), ("lasts", (rows,)),
            ("tables", (n_stages, rows, n_pages))]


def _layout_size(layout) -> int:
    """The int32 elements of a packed input (``_chunk_layout``)."""
    return sum(int(np.prod(shape)) for _, shape in layout)


def _unpack(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Views of a packed input's pieces (``_chunk_layout``)."""
    out, at = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        out[name] = buf[at:at + n].view(shape)
        at += n
    return out


@dataclass
class _PrefillStatics:
    """The static tensors of one prefill shape: the packed input, one copy
    a device; each stage's output activation and, past stage 0, its input
    (pipe chunks and exact prefills over several stages); the logits."""
    inp: Dict[torch.device, torch.Tensor]
    act_in: list
    act_out: list
    out: torch.Tensor


def stage_devices(mesh, n_stages: int, device) -> List[torch.device]:
    """The device of each pipeline stage.  ``mesh`` is ``None`` (every stage
    on ``device``) or a list of ``n_stages`` torch devices, which may repeat
    one; stage 0 must be ``device``, the engine's, where its host-made
    tensors land.  Each entry must exist: a CUDA entry raises
    ``resolve_device``'s ``RuntimeError`` without a card and ``ValueError``
    past the visible cards.  The devices come back with their card index
    (``models.common.stage_device``)."""
    device = stage_device(device)
    if mesh is None:
        return [device] * n_stages
    devs = [stage_device(d) for d in mesh]
    if len(devs) != n_stages:
        raise ValueError(f"mesh has {len(devs)} device(s) for {n_stages} "
                         "stage(s): one device a stage")
    if devs[0] != device:
        raise ValueError(f"mesh puts stage 0 on {devs[0]}, but the engine "
                         f"runs on {device}: stage 0 must be the engine's "
                         "device")
    return devs


def reserve_paged_workspace(cfg: ModelConfig, pool: kvc.PoolConfig,
                            batch: int, device: torch.device) -> None:
    """Size the paged kernel's workspace on ``device`` for every launch a
    decode step over ``batch`` rows of ``pool``'s table width makes
    (``kernels.paged_attention.reserve_workspace``).  An arch with no
    paged layer, and the CPU (the plain paged attention), need none."""
    if device.type == "cuda" and \
            any(k in model_lib.PAGED_KINDS for k in cfg.layer_kinds()):
        paged_lib.reserve_workspace(
            device, batch=batch, heads=cfg.num_heads,
            kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            max_pages=pool.max_pages_per_seq, page_size=pool.page_size)


class _SlotCacheBackend:
    """Shared plumbing over engine-format paged caches: the device caches,
    page-table pushes, slot resets and the exact-length prefill; the
    subclasses tick the decode and prefill planes."""

    name = "abstract"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, caches: Optional[dict] = None,
                 devices: Optional[List[torch.device]] = None,
                 ranges: Optional[list] = None):
        self.cfg = cfg
        self.params = params
        self.rt = rt
        self.mb_size = mb_size
        self.num_microbatches = num_microbatches
        self.batch = mb_size * num_microbatches
        self.pool = pool
        self.device = device = stage_device(device)     # stage 0's
        # the stages' devices and layer ranges, then the epilogue's range
        # (one stage holding every layer on a local backend)
        self.stage_devices = devices or [device]
        self.ranges = ranges or [(0, cfg.num_layers),
                                 (cfg.num_layers, cfg.num_layers)]
        self._devices = list(dict.fromkeys(self.stage_devices))
        # a tied head's table where the last stage's device is not stage
        # 0's (None: the head reads ``params``)
        self.head = model_lib.tied_head(params, cfg, self.stage_devices[-1])
        # a reshard hands the old backend's caches over; the engine has
        # placed them, and the weights, by stage
        self.caches = caches if caches is not None else \
            kvc.build_paged_caches(cfg, self.batch, pool, rt, device)
        self._noise_gen: Optional[torch.Generator] = None
        self.decode_ticks = 0           # decode-plane ticks
        # the captured steps, and the decode steps' static inputs and
        # outputs (built at the first decode tick, by the subclass)
        self.graphs = StepGraphs(prepare=self._reserve_workspace)
        self._inp: Optional[Dict[torch.device, torch.Tensor]] = None
        self._noise: Optional[torch.Tensor] = None
        self._out: Optional[torch.Tensor] = None
        # the captured prefill steps' statics, by chunk shape or bucket
        self._pf: Dict[tuple, _PrefillStatics] = {}
        self.exact_prefills = 0         # exact-length prefill calls
        self.recorder = None            # repro_torch.obs TraceRecorder
        self._lap_t = 0.0               # where the next backend span starts

    @property
    def noise_gen(self) -> torch.Generator:
        """The sampler's generator, on the last stage's device, where
        sampling runs (reseeded by ``(seed, request_id, token_idx)`` for
        every row, so the rows equal one card's)."""
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device=self.stage_devices[-1])
        return self._noise_gen

    def set_recorder(self, recorder) -> None:
        """Record into ``recorder`` (a ``TraceRecorder``, or None: off)
        from the next call on."""
        self.recorder = recorder

    def _lap(self, name: str, data: tuple = ()) -> None:
        """Record span ``name`` on the backend track from the end of the
        last one (or the call's start) to now.  Callers gate on
        ``self.recorder is not None``."""
        now = time.perf_counter()
        self.recorder.span(name, BACKEND_TRACK, self._lap_t, now,
                           data=data)
        self._lap_t = now

    def set_page_table(self, table: np.ndarray) -> None:
        self.caches = kvc.set_page_table(self.caches, table)

    def reset_slot(self, slot: int) -> None:
        """Clear a reassigned slot's per-row state (ring positions,
        recurrent states), in place, on each layer's device."""
        self.caches = kvc.reset_slot(self.caches, slot)

    def _sync(self) -> None:
        for dev in self._devices:
            if dev.type == "cuda":
                # repro-torch-audit: allow(host-sync) — once a prefill phase (chunk or exact prefill) and a pipe tick that drains nothing, on every stage's card, so the phase clocks and stage times measure the cards
                torch.cuda.synchronize(dev)

    # -- the pipe's state (a local backend has nothing in flight) ----------

    def busy_microbatches(self) -> set:
        """Microbatches with a tick in flight: admission must not touch
        their slots or cache rows."""
        return set()

    def pending(self) -> bool:
        """True while decode ticks are in flight (the engine keeps
        draining)."""
        return False

    def prefill_can_accept(self) -> bool:
        """True when a new prefill chunk may be injected this tick."""
        return True

    def prefill_pending(self) -> bool:
        """True while prefill chunks are in flight."""
        return False

    def transport_stats(self) -> Dict:
        """The inter-stage transport's books (virtual clock, wire bytes,
        link stalls); empty where there are no stages or no books."""
        return {}

    def graph_entries(self) -> Dict[object, tuple]:
        """Each captured step's key (decode and prefill) and its ``(graph
        identity, captures)``, for the strict auditor: a key is captured
        once for the backend's life (the counterpart of the JAX backends'
        ``jit_entries``).  Empty off the card."""
        return self.graphs.entries()

    def _reserve_workspace(self, device: torch.device) -> None:
        """Size the paged kernel's workspace on ``device`` for every launch
        a captured step makes there before its first capture."""
        reserve_paged_workspace(self.cfg, self.pool, self.mb_size, device)

    def _statics(self, n_ints: int) -> None:
        """Build the static tensors of the decode steps once: one packed
        int32 input a device (``n_ints`` rows, then top-k, temperature and
        top-p), the sampler's noise and the (tokens, log-probs) output on
        the last stage's device."""
        if self._inp is None:
            last = self.stage_devices[-1]
            self._inp = {d: torch.zeros((n_ints + 3, self.mb_size),
                                        dtype=torch.int32, device=d)
                         for d in self._devices}
            self._noise = torch.zeros((self.mb_size, self.cfg.vocab_size),
                                      dtype=torch.float32, device=last)
            self._out = torch.zeros((2, self.mb_size), dtype=torch.float32,
                                    device=last)

    def _load_inputs(self, ints: Sequence[np.ndarray],
                     samp: Optional[RowSampling]) -> None:
        """Copy the tick's host inputs into the static inputs: one copy a
        device.  Callers do this before any swap is enqueued (see
        ``LocalBackend._residency``)."""
        host = np.zeros((len(ints) + 3, self.mb_size), np.int32)
        for i, a in enumerate(ints):
            host[i] = a
        if samp is not None:
            host[-3] = samp.top_k
            host[-2] = np.asarray(samp.temp, np.float32).view(np.int32)
            host[-1] = np.asarray(samp.top_p, np.float32).view(np.int32)
        src = torch.from_numpy(host)
        for buf in self._inp.values():
            buf.copy_(src)
        if self.recorder is not None:
            self._lap("decode.inputs")

    def _draw_noise(self, samp: Optional[RowSampling],
                    sampled: bool) -> None:
        """The sampled rows' Gumbel noise into the static noise, on the
        last stage's device, where sampling runs."""
        if sampled:
            gumbel_noise(samp, self.cfg.vocab_size, self.stage_devices[-1],
                         self.noise_gen, out=self._noise)
        if self.recorder is not None:
            rows = int(np.count_nonzero(samp.temp > 0)) if sampled else 0
            self._lap("decode.noise", (("rows", rows),))

    def _read_out(self, mb: int) -> DecodeResult:
        """The tick's one device-to-host transfer: the drained tokens and
        log-probs, which the engine books on the host."""
        # repro-torch-audit: allow(host-sync) — the tick's one device-to-host transfer (tokens and log-probs in one copy)
        out = self._out.cpu().numpy()
        res = DecodeResult(mb=mb, tokens=out[0].astype(np.int32),
                           logprobs=out[1].copy())
        if self.recorder is not None:
            self._lap("decode.readout")
        return res

    def _prefill_statics(self, key: tuple, n_ints: int, act_shape: tuple,
                         rows: int, last_out: bool) -> _PrefillStatics:
        """The statics of prefill shape ``key``, built at its first call:
        an ``n_ints`` int32 input on each device, ``act_shape`` activations
        between the stages (the last stage's output too with
        ``last_out``: a pipe drain reads it), and the (``rows``, V) float32
        logits on the last stage's device."""
        st = self._pf.get(key)
        if st is None:
            devs, dt = self.stage_devices, self.rt.compute_dtype
            outs = devs if last_out else devs[:-1]
            st = self._pf[key] = _PrefillStatics(
                inp={d: torch.zeros((n_ints,), dtype=torch.int32, device=d)
                     for d in self._devices},
                act_in=[None] + [torch.zeros(act_shape, dtype=dt, device=d)
                                 for d in devs[1:]],
                act_out=[torch.zeros(act_shape, dtype=dt, device=d)
                         for d in outs] + [None] * (len(devs) - len(outs)),
                out=torch.zeros((rows, self.cfg.vocab_size),
                                dtype=torch.float32, device=devs[-1]))
        return st

    def _load(self, st: _PrefillStatics,
              arrays: Sequence[np.ndarray]) -> None:
        """Copy a prefill call's host arrays, packed, into its static input
        on every device (before any swap is enqueued: see
        ``LocalBackend._residency``)."""
        src = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int32).ravel() for a in arrays]))
        for buf in st.inp.values():
            buf.copy_(src)
        if self.recorder is not None:
            self._lap("prefill.inputs")

    def kernel_libraries(self) -> Dict[str, object]:
        """The kernel libraries loaded so far, by name, for the strict
        auditor: each must stay the one library of its name for the whole
        serve (a second build or load mid-serve is the eager counterpart
        of a jit retrace).  Empty off the card."""
        return kernel_build.loaded()

    # -- exact-length prefill ------------------------------------------------

    def _prefill_residency(self, mb: int) -> None:
        """Make ``mb``'s global pools resident before a prefill writes
        prompt KV into them (without this the next swap would clobber it)."""

    def prefill(self, tokens: np.ndarray, slot: int, last_index: int,
                has_global_pages: bool = True) -> torch.Tensor:
        """Prefill one whole prompt, right-padded to ``len(tokens)``, into
        ``slot`` through the whole model; returns its logits (V,) at
        ``last_index``, on the last stage's device.  Each stage is the
        captured step of key ``("exact", len(tokens), s)``, captured at
        the bucket's second call (its first runs the step eagerly); the
        activation is copied to the next stage's static input between
        them."""
        if self.recorder is not None:
            self._lap_t = time.perf_counter()
        n, L = len(self.stage_devices), len(tokens)
        st = self._prefill_statics(("exact", L), 2 + L,
                                   (1, L, self.cfg.d_model), 1, False)
        self._load(st, [[slot, last_index], tokens])
        if has_global_pages:
            self._prefill_residency(slot // self.mb_size)
        for s, dev in enumerate(self.stage_devices):
            self.graphs.run(("exact", L, s), dev,
                            partial(self._exact_step, st, s),
                            state=partial(kvc.state_rows, self.caches, slot,
                                          1, self._exact_range(s)),
                            defer=True)
            if s < n - 1:
                st.act_in[s + 1].copy_(st.act_out[s])
        if self.recorder is not None:
            self._lap("prefill.launch")
        self.exact_prefills += 1
        logits = st.out[0].clone()
        # as prefill_step: the prefill phase's clock measures the card
        self._sync()
        if self.recorder is not None:
            self._lap("prefill.wait")
        return logits

    def _exact_range(self, s: int) -> tuple:
        """Stage ``s``'s layers in an exact prefill: its range, and on the
        last stage the epilogue's too (it runs on that stage's device)."""
        lo, hi = self.ranges[s]
        if s == len(self.stage_devices) - 1:
            hi = self.ranges[-1][1]
        return lo, hi

    def _exact_step(self, st: _PrefillStatics, s: int) -> None:
        """The captured step of stage ``s`` of an exact prefill: the slot's
        rows gathered by the device slot index (``kvc.slot_take``), the
        stage's layers from the embedded tokens (stage 0) or its static
        input, the ring positions past the last index cleaned back to -1,
        the rows written back; then the stage's static output, or on the
        last stage the logits at the last index."""
        dev = self.stage_devices[s]
        inp = st.inp[dev]
        slot, last = inp[0:1].long(), inp[1:2]
        lo, hi = self._exact_range(s)
        L = inp.shape[0] - 2
        if s == 0:
            x, pos = model_lib.embed_inputs(self.params,
                                            {"tokens": inp[None, 2:]},
                                            self.cfg, self.rt)
        else:
            x = st.act_in[s]
            pos = model_lib.token_positions(1, L, self.cfg, dev)
        pos, li = model_lib.mark_padding(pos, last)
        view = kvc.slot_take(self.caches, slot, (lo, hi), dev)
        y = model_lib.run_layers(self.params, x, self.cfg, self.rt,
                                 mode="prefill", caches=view, positions=pos,
                                 layers=(lo, hi))
        for layer in view["layers"][lo:hi]:
            if "pos" in layer:
                layer["pos"].masked_fill_(layer["pos"] > last, -1)
        kvc.slot_put(self.caches, slot, view)
        if s < len(self.stage_devices) - 1:
            st.act_out[s].copy_(y)
        else:
            st.out.copy_(model_lib.prefill_head(self.params, y, li,
                                                self.cfg, self.head))

    @staticmethod
    def _prefill_fn(params, caches, tokens, slot, last_idx, *, cfg, rt,
                    ranges, devices, head):
        """One sequence into the batch-wide caches at ``slot``, through
        ``models.model.prefill`` walking the stages: each stage's layer
        range on its device against a one-row view of the rings, the
        recurrent states and its device's page table (the JAX package's
        slot_view / slot_merge: pools, rings and states are written in
        place through it), the head on the last stage's device.  Ring
        positions past the true last index are cleaned back to -1
        afterwards."""
        views = {d: kvc.slot_view(caches, slot, 1, d) for d in devices}
        last = torch.full((1,), last_idx, dtype=torch.int32,
                          device=tokens.device)
        stages = [(r, d, views[d])
                  for r, d in zip(ranges, [*devices, devices[-1]])]
        logits, _ = model_lib.prefill(params, {"tokens": tokens}, cfg, rt,
                                      last_index=last, stages=stages,
                                      head=head)
        for layer in views[devices[0]]["layers"]:
            if "pos" in layer:
                layer["pos"].masked_fill_(layer["pos"] > last_idx, -1)
        return logits[0]


class LocalBackend(_SlotCacheBackend):
    """The single-device path: one model call per prefill chunk and one per
    microbatch decode tick, over an ``mb_size`` row view of the caches."""

    name = "local"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, offloader=None,
                 caches: Optional[dict] = None, recorder=None):
        super().__init__(cfg, params, rt, mb_size=mb_size,
                         num_microbatches=num_microbatches, pool=pool,
                         device=device, caches=caches)
        self.offloader = offloader
        self.set_recorder(recorder)
        self.prefill_chunks = 0         # prefill chunks run

    def set_recorder(self, recorder) -> None:
        super().set_recorder(recorder)
        if self.offloader is not None:
            self.offloader.recorder = recorder

    def _residency(self, mb: int) -> None:
        """Make ``mb``'s global-pool parity resident before the model
        writes or reads it (without this a prefill could write prompt KV
        into another microbatch's content, which the next swap would
        clobber).  Callers copy their host inputs to the card first: a
        blocking host-to-device copy synchronises the compute stream, which
        after this call waits on the swap, so a copy made later would hold
        the host for the whole swap instead of letting it issue the model's
        launches meanwhile."""
        if self.offloader is not None:
            self.caches = self.offloader.ensure_resident(self.caches, mb)

    _prefill_residency = _residency

    @property
    def swap_count(self) -> int:
        return self.offloader.swap_count if self.offloader else 0

    # -- chunked prefill ---------------------------------------------------

    def prefill_step(self, chunk: Optional[PrefillChunk]
                     ) -> List[PrefillResult]:
        if chunk is None:
            return []
        if self.recorder is not None:
            self._lap_t = time.perf_counter()
        rows, clen = chunk.tokens.shape
        key = ("chunk", rows, clen, chunk.tables.shape[1])
        layout = _chunk_layout(*key[1:], 1)
        st = self._prefill_statics(key, _layout_size(layout), (), rows,
                                   False)
        self._load(st, (chunk.tokens, chunk.offsets, chunk.n_valid,
                        chunk.lasts, chunk.tables))
        for mb in chunk.residency_mbs:
            self._residency(mb)
        self.graphs.run(key, self.device,
                        partial(self._chunk_step, st, layout))
        if self.recorder is not None:
            self._lap("prefill.launch")
        self.prefill_chunks += 1
        logits = st.out.clone()
        # the chunk's work ends inside the engine's prefill phase, so its
        # prefill/decode time split measures the card, not the queue
        self._sync()
        if self.recorder is not None:
            self._lap("prefill.wait")
        return [PrefillResult(chunk=chunk, logits=logits)]

    def _chunk_step(self, st: _PrefillStatics, layout) -> None:
        """The captured step: ``_chunk_fn`` over the static input into the
        static logits."""
        v = _unpack(st.inp[self.device], layout)
        st.out.copy_(self._chunk_fn(
            self.params, self.caches, v["tokens"], v["offsets"][0],
            v["n_valid"][0], v["lasts"], v["tables"][0], cfg=self.cfg,
            rt=self.rt))

    @staticmethod
    def _chunk_fn(params, caches, tokens, offsets, n_valid, lasts, tables,
                  *, cfg, rt):
        """One prefill chunk: the model sees the chunk's own table rows
        (the device-wide table keeps prefilling slots parked on the scratch
        page until activation); pools are written in place."""
        view = {"layers": caches["layers"], "page_table": tables}
        logits, _ = model_lib.prefill_chunk(params, tokens, view, offsets,
                                            n_valid, lasts, cfg, rt)
        return logits

    # -- decode --------------------------------------------------------------

    def decode(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
               samp: RowSampling, active: bool = True) -> List[DecodeResult]:
        if not active:
            return []
        if self.recorder is not None:
            self._lap_t = time.perf_counter()
        sampled = samp.any_sampled
        self._statics(2)
        self._load_inputs((tokens, cur_pos), samp)
        self._draw_noise(samp, sampled)
        self._residency(mb)
        row0 = mb * self.mb_size
        self.graphs.run(("local", mb, sampled), self.device,
                        partial(self._decode_step, row0, sampled),
                        state=partial(kvc.state_rows, self.caches, row0,
                                      self.mb_size))
        if self.recorder is not None:
            self._lap("decode.launch")
        self.decode_ticks += 1
        return [self._read_out(mb)]

    def _decode_step(self, row0: int, sampled: bool) -> None:
        """The captured step: ``_decode_fn`` over the static inputs into
        the static output."""
        inp = self._inp[self.device]
        toks, lps = self._decode_fn(
            self.params, self.caches, inp[0], inp[1], row0,
            self._noise if sampled else None, inp[-2].view(torch.float32),
            inp[-3], inp[-1].view(torch.float32), cfg=self.cfg, rt=self.rt,
            mb_size=self.mb_size, sampled=sampled)
        self._out[0].copy_(toks)
        self._out[1].copy_(lps)

    @staticmethod
    def _decode_fn(params, caches, tokens, cur_pos, row0, noise, temp, top_k,
                   top_p, *, cfg, rt, mb_size, sampled):
        """One decode tick over an ``mb_size`` row view of the caches; rows
        outside the microbatch are untouched.  The view aliases the table,
        ring and recurrent-state rows, and pools, rings and states are
        written in place, so there is nothing to merge back.  ``sampled``
        (decided on the host) skips the truncation pass when every row is
        greedy."""
        view = kvc.slot_view(caches, row0, mb_size)
        logits, _ = model_lib.decode_step(params, tokens, view, cur_pos, cfg,
                                          rt)
        if sampled:
            toks = sample_batched(logits, noise, temp, top_k, top_p)
        else:
            toks = greedy(logits)
        return toks, token_logprobs(logits, toks)


class PipelinedBackend(_SlotCacheBackend):
    """DeServe's §4.3 circular schedule as a persistent stepper.

    Two shift registers hold what sits at each stage: ``_entries`` for the
    decode plane (``(mb, positions, RowSampling)`` captured at injection)
    and ``_pf_entries`` for the prefill plane (:class:`PrefillChunk`), with
    ``_act_in`` and the prefill statics' ``act_in`` the activations waiting
    at each stage's input.
    ``schedule="round_flush"`` reproduces the vLLM-PP baseline: the pipe is
    drained every token round (when the microbatch counter wraps), with
    the same ticks, so outputs are unchanged and only the virtual clock
    pays the fill and drain.  ``wire_dtype="int8"`` passes each stage's
    output on as its per-row int8 round trip and books the packed payload
    (a ``CompressedTransport`` wrap)."""

    name = "pipelined"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, n_stages: int = 2,
                 offload: bool = False, offload_async: bool = True,
                 mesh=None, transport=None, schedule: str = "circular",
                 wire_dtype: str = "fp32", fault_plan=None,
                 caches: Optional[dict] = None, recorder=None):
        if wire_dtype not in PL.WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be 'fp32'|'int8', got "
                             f"{wire_dtype!r} (top-k has no codec in the "
                             "ticks — it stays wire-byte accounting only)")
        if num_microbatches < n_stages:
            raise ValueError(
                f"continuous batching over a {n_stages}-stage pipe needs "
                f"N_B >= N_S (got N_B={num_microbatches}); see §4.3 — a "
                "microbatch must drain before its next injection")
        if schedule not in ("circular", "round_flush"):
            raise ValueError(f"schedule must be 'circular'|'round_flush', "
                             f"got {schedule!r}")
        if fault_plan is not None:
            bad = sorted({e.stage for e in fault_plan.events
                          if e.stage >= n_stages})
            if bad:
                raise ValueError(
                    f"fault plan targets stage(s) {bad} but the pipe has "
                    f"only {n_stages} stage(s) — fix the "
                    "kind@plane:tick:stage spec")
        # stage s owns its layers' weights and caches on devs[s] (the
        # epilogue's on the last stage's); the caller has placed the
        # weights and any caches it hands over (OfflineEngine does)
        devs = stage_devices(mesh, n_stages, device)
        if caches is None:
            caches = kvc.build_paged_caches(
                cfg, mb_size * num_microbatches, pool, rt, devs[0],
                layer_devices=PL.layer_devices(cfg, devs))
        super().__init__(cfg, params, rt, mb_size=mb_size,
                         num_microbatches=num_microbatches, pool=pool,
                         device=devs[0], caches=caches, devices=devs,
                         ranges=PL.stage_ranges(cfg, n_stages))
        self.fault_plan = fault_plan
        # plane ticks in which something was in flight, a tick whose only
        # entry a fault dropped included: the FaultPlan's tick indices
        # (decode_ticks counts the decode plane's)
        self.prefill_ticks = 0
        self._stage_times: List[tuple] = []     # (stage, seconds) since the
                                                # last drain_stage_times()
        self.n_stages = n_stages
        self.wire_dtype = wire_dtype
        self.schedule = schedule
        self._act_in: Optional[list] = None     # static stage inputs and
        self._act_out: Optional[list] = None    # outputs (_pipe_statics)
        self._entries: List[Optional[tuple]] = [None] * n_stages
        self._pf_entries: List[Optional[PrefillChunk]] = [None] * n_stages
        self.decode_stage_runs = 0      # occupied stages summed over the
                                        # decode ticks (a stage run is one
                                        # pass over the stage's layers)
        self.epilogue_runs = 0          # decode ticks that drained
        self.prefill_stage_runs = 0     # occupied stages summed over the
                                        # prefill ticks
        self.prefill_drains = 0         # prefill ticks that drained
        self._last_inject_mb = -1       # round boundary detector
        self._ret_ready: Dict[int, float] = {}  # mb -> virtual time its
                                                # drained return payload
                                                # lands at the injector
        self._dtype_bytes = torch.empty((), dtype=rt.compute_dtype
                                        ).element_size()

        # inter-stage links: every entry crossing a stage boundary, decode
        # microbatches and prefill chunks, travels the transport; the call
        # sites pass RAW activation bytes, so a real int8 wire forces the
        # matching CompressedTransport wrap (or retunes an existing one)
        self.transport = make_transport(transport, n_stages)
        if wire_dtype == "int8" and \
                not isinstance(self.transport, InProcessTransport):
            if isinstance(self.transport, CompressedTransport):
                if self.transport.method != "int8":
                    raise ValueError(
                        f"wire_dtype='int8' but the transport accounts "
                        f"'{self.transport.method}' — use one codec for "
                        "both the wire and the books")
                self.transport.elem_bytes = self._dtype_bytes
                self.transport.row_elems = cfg.d_model
                self.transport._wire_cache.clear()
            else:
                self.transport = CompressedTransport(
                    self.transport, method="int8",
                    elem_bytes=self._dtype_bytes,
                    row_elems=cfg.d_model).bind(n_stages)

        # §4.2 offloading, per stage: stage s double-buffers its own layers'
        # slice of the global pools; the epilogue is one more unit, keyed
        # to the draining microbatch, when it holds paged layers
        self.stage_offloaders: List[DoubleBufferOffloader] = []
        self.epilogue_offloader: Optional[DoubleBufferOffloader] = None
        if offload and pool.n_global_pages:
            self.stage_offloaders = [
                DoubleBufferOffloader(pool, num_microbatches,
                                      async_swap=offload_async)
                for _ in range(n_stages)]
            if any("k_pages" in c for c in self._epi_view()["layers"]):
                self.epilogue_offloader = DoubleBufferOffloader(
                    pool, num_microbatches, async_swap=offload_async)
        self.set_recorder(recorder)

    def set_recorder(self, recorder) -> None:
        super().set_recorder(recorder)
        # the flight recorder rides on the OUTER transport (a compressed
        # wrap forwards to its inner, which accumulates the books, so the
        # recorded ledger carries the re-priced wire bytes)
        self.transport.set_recorder(recorder)
        for off in self._offload_units():
            off[0].recorder = recorder

    # -- per-stage offload residency ---------------------------------------

    def _stage_view(self, s: int) -> dict:
        lo, hi = self.ranges[s]
        return {"layers": self.caches["layers"][lo:hi]}

    def _epi_view(self) -> dict:
        lo, hi = self.ranges[self.n_stages]
        return {"layers": self.caches["layers"][lo:hi]}

    def _ensure_stage_resident(self, s: int, mb: int) -> None:
        if self.stage_offloaders:
            self.stage_offloaders[s].ensure_resident(self._stage_view(s), mb)

    def _ensure_epi_resident(self, mb: int) -> None:
        if self.epilogue_offloader is not None:
            self.epilogue_offloader.ensure_resident(self._epi_view(), mb)

    def _prefill_residency(self, mb: int) -> None:
        # an exact prefill writes every layer's pools: every stage unit and
        # the epilogue
        for s in range(self.n_stages):
            self._ensure_stage_resident(s, mb)
        self._ensure_epi_resident(mb)

    @property
    def swap_count(self) -> int:
        epi = self.epilogue_offloader
        return sum(o.swap_count for o in self.stage_offloaders) + \
            (epi.swap_count if epi is not None else 0)

    # -- the prefill stepper -------------------------------------------------

    def prefill_can_accept(self) -> bool:
        return self._pf_entries[0] is None

    def prefill_pending(self) -> bool:
        return any(e is not None for e in self._pf_entries)

    def prefill_step(self, chunk: Optional[PrefillChunk]
                     ) -> List[PrefillResult]:
        if self.recorder is not None:
            self._lap_t = time.perf_counter()
        entries = list(self._pf_entries)
        if chunk is not None:
            if entries[0] is not None:
                raise RuntimeError("prefill pipe stage 0 is occupied")
            entries[0] = chunk
        if not any(e is not None for e in entries):
            return []
        tick = self.prefill_ticks
        self.prefill_ticks += 1
        delays, lost = self._take_faults("prefill", tick, entries)
        if self.recorder is not None and (lost or delays):
            self._record_faults("prefill", [-1] * len(lost), delays)
        results = [PrefillResult(chunk=c, logits=None, lost=True)
                   for c in lost]
        if not any(e is not None for e in entries):
            self._pf_entries = [None] * self.n_stages
            return results
        ref = next(e for e in entries if e is not None)
        rows, clen = ref.tokens.shape
        n_pages_row = ref.tables.shape[1]
        tokens = entries[0].tokens if entries[0] is not None \
            else np.zeros((rows, clen), np.int32)
        offs = np.zeros((self.n_stages, rows), np.int32)
        nval = np.zeros((self.n_stages, rows), np.int32)
        tabs = np.zeros((self.n_stages, rows, n_pages_row), np.int32)
        for s, e in enumerate(entries):
            if e is not None:
                offs[s], nval[s], tabs[s] = e.offsets, e.n_valid, e.tables
        drained = entries[-1]
        lasts = drained.lasts if drained is not None \
            else np.zeros((rows,), np.int32)
        # host inputs go to the stages' devices before any swap is enqueued
        # (see LocalBackend._residency): one packed copy a device
        shape = (rows, clen, n_pages_row)
        layout = _chunk_layout(*shape, self.n_stages)
        st = self._prefill_statics(("pf",) + shape, _layout_size(layout),
                                   (rows, clen, self.cfg.d_model), rows,
                                   True)
        self._load(st, (tokens, offs, nval, lasts, tabs))
        for s, e in enumerate(entries):
            for mb in (e.residency_mbs if e is not None else ()):
                self._ensure_stage_resident(s, mb)
        for mb in (drained.residency_mbs if drained is not None else ()):
            self._ensure_epi_resident(mb)
        occupied = [e is not None for e in entries]
        devs, n = self.stage_devices, self.n_stages
        captured = self.graphs.capture_s
        t0 = time.perf_counter()
        for s in range(n):
            if occupied[s]:             # a bubble does no work
                self.graphs.run(("pf-stage", s) + shape, devs[s],
                                partial(self._pf_stage_step, st, layout, s))
        logits = None
        if drained is not None:
            self.graphs.run(("pf-drain",) + shape, devs[-1],
                            partial(self._pf_drain_step, st, layout))
            logits = st.out.clone()
        # each stage's output becomes the next stage's input for the next
        # tick, after this tick's stages read theirs
        for s in range(n - 1):
            if occupied[s]:
                st.act_in[s + 1].copy_(PL._wire(st.act_out[s],
                                                self.wire_dtype, devs[s + 1]))
        if self.recorder is not None:
            self._lap("prefill.launch")
        self.prefill_stage_runs += sum(occupied)
        self.prefill_drains += drained is not None
        # the tick's device work ends inside the engine's prefill phase,
        # and the stage time the transport books is the card's
        self._sync()
        t1 = time.perf_counter()
        if self.recorder is not None:
            self._lap("prefill.wait")
        # a key's first tick warms up and captures its step: the stage
        # times leave it out, as the decode tick's do
        dt = t1 - t0 - (self.graphs.capture_s - captured)
        # the chunk activation (R, C, D) crosses each occupied boundary
        obs = self.transport.tick(
            occupied, rows * clen * self.cfg.d_model * self._dtype_bytes,
            _stage_seconds(dt, occupied), plane="prefill")
        self._observe_stages(dt, occupied, delays, obs.stalls)
        if self.recorder is not None:
            # per-stage occupancy: prompt rows in flight at each stage
            # (host ints the stepper already holds)
            self.recorder.pipe_tick(
                "prefill", t0, t1,
                tuple(len(e.seqs) if e is not None else 0
                      for e in entries))
        self._pf_entries = [None] + entries[:-1]
        if drained is None:
            return results
        return results + [PrefillResult(chunk=drained, logits=logits)]

    def _pf_stage_step(self, st: _PrefillStatics, layout, s: int) -> None:
        """The captured step of prefill stage ``s``: its layers from the
        embedded tokens (stage 0) or its static input, into its static
        output."""
        v = _unpack(st.inp[self.stage_devices[s]], layout)
        x = PL.embed_chunk_tokens(self.params, v["tokens"], self.cfg,
                                  self.rt) if s == 0 else st.act_in[s]
        st.act_out[s].copy_(PL.chunk_stage(
            self.params, self.caches, x, v["offsets"][s], v["n_valid"][s],
            v["tables"][s], stage=s, cfg=self.cfg, rt=self.rt,
            n_stages=self.n_stages))

    def _pf_drain_step(self, st: _PrefillStatics, layout) -> None:
        """The captured step of the drained chunk: the epilogue and the
        logits at its last indices from the last stage's output, into the
        static logits."""
        n = self.n_stages
        v = _unpack(st.inp[self.stage_devices[-1]], layout)
        st.out.copy_(PL.chunk_drain(
            self.params, self.caches, st.act_out[n - 1], v["offsets"][n - 1],
            v["n_valid"][n - 1], v["tables"][n - 1], v["lasts"],
            cfg=self.cfg, rt=self.rt, n_stages=n, head=self.head))

    # -- the decode stepper ----------------------------------------------------

    def busy_microbatches(self) -> set:
        return {e[0] for e in self._entries if e is not None}

    def pending(self) -> bool:
        return any(e is not None for e in self._entries)

    def decode(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
               samp: RowSampling, active: bool = True) -> List[DecodeResult]:
        results: List[DecodeResult] = []
        if active and self.schedule == "round_flush" \
                and mb <= self._last_inject_mb:
            # vLLM-PP behaviour: the microbatch counter wrapped — a new
            # token round starts, so drain the pipe completely first
            # (fill/drain bubbles every round).  The drained results ride
            # back with this call; the engine books them by mb id.
            while self.pending():
                results += self._decode_tick(mb, tokens, cur_pos, samp,
                                             active=False)
            self._last_inject_mb = -1
        if active:
            self._last_inject_mb = mb
        return results + self._decode_tick(mb, tokens, cur_pos, samp,
                                           active=active)

    def _decode_tick(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
                     samp: RowSampling, active: bool) -> List[DecodeResult]:
        if self.recorder is not None:
            self._lap_t = time.perf_counter()
        entries = list(self._entries)
        entries[0] = (mb, np.asarray(cur_pos, np.int32).copy(), samp) \
            if active else None
        if not any(e is not None for e in entries):
            return []
        tick = self.decode_ticks
        self.decode_ticks += 1
        delays, lost = self._take_faults("decode", tick, entries)
        if self.recorder is not None and (lost or delays):
            self._record_faults("decode", [e[0] for e in lost], delays)
        results = [DecodeResult(mb=e[0],
                                tokens=np.zeros((self.mb_size,), np.int32),
                                logprobs=np.zeros((self.mb_size,),
                                                  np.float32), lost=True)
                   for e in lost]
        if not any(e is not None for e in entries):
            self._entries = [None] * self.n_stages
            return results
        mb_assign = [e[0] if e is not None else -1 for e in entries]
        n, devs = self.n_stages, self.stage_devices
        drained = entries[-1]
        # sampling travels with the microbatch: the tick samples the
        # *draining* microbatch with the RowSampling captured at injection
        dsamp = drained[2] if drained is not None else None
        sampled = dsamp is not None and dsamp.any_sampled
        self._statics(n + 1)
        self._pipe_statics()
        # host inputs go to the stages' devices before any swap is
        # enqueued: the tokens, each stage's positions and the draining
        # rows' sampling, one packed copy a device
        idle = np.zeros((self.mb_size,), np.int32)
        self._load_inputs([tokens] + [e[1] if e is not None else idle
                                      for e in entries], dsamp)
        self._draw_noise(dsamp, sampled)
        for s, e in enumerate(entries):
            if e is not None:
                self._ensure_stage_resident(s, e[0])
        if drained is not None:
            self._ensure_epi_resident(drained[0])
        captured = self.graphs.capture_s
        t0 = time.perf_counter()
        for s, m in enumerate(mb_assign):
            if m >= 0:                  # a bubble does no work
                self.graphs.run(("stage", s, m), devs[s],
                                partial(self._stage_step, s, m),
                                state=partial(self._state_rows, s, m))
        out = None
        if drained is not None:
            self.graphs.run(("drain", drained[0], sampled), devs[-1],
                            partial(self._drain_step, drained[0], sampled),
                            state=partial(self._state_rows, n, drained[0]))
        # each stage's output becomes the next stage's input for the next
        # tick (the ppermute), after this tick's stages read theirs
        for s in range(n - 1):
            if mb_assign[s] >= 0:
                self._act_in[s + 1].copy_(PL._wire(
                    self._act_out[s], self.wire_dtype, devs[s + 1]))
        if self.recorder is not None:
            self._lap("decode.launch")
        if drained is not None:
            # §4.3 return link: the drained microbatch's token ids ride
            # back to the host injector — the tick's one device-to-host
            # transfer, which also ends its device work
            out = self._read_out(drained[0])
        else:
            self._sync()            # the stage times below are the card's
            if self.recorder is not None:
                self._lap("decode.readout")
        t1 = time.perf_counter()
        # a key's first tick warms up and captures its step, a one-off
        # that is no stage's compute: the stage times leave it out (the
        # straggler mitigation would read it as a slow stage)
        dt = t1 - t0 - (self.graphs.capture_s - captured)
        occupied = [e is not None for e in entries]
        self.decode_stage_runs += sum(occupied)
        # the (mb_size, 1, D) activation crosses each occupied boundary;
        # an injection may not start before its microbatch's previous
        # drain returned over the last link (the §4.3 dependency)
        obs = self.transport.tick(
            occupied, self.mb_size * self.cfg.d_model * self._dtype_bytes,
            _stage_seconds(dt, occupied),
            inject_t=self._ret_ready.get(mb, 0.0)
            if entries[0] is not None else 0.0, plane="decode")
        self._observe_stages(dt, occupied, delays, obs.stalls)
        if self.recorder is not None:
            # per-stage occupancy: which microbatch sat in each stage slot
            # this tick (-1 = bubble), host ints from mb_assign
            self.recorder.pipe_tick("decode", t0, t1, tuple(mb_assign))
        self._entries = [None] + entries[:-1]
        if drained is None:
            return results
        self.epilogue_runs += 1
        self._ret_ready[drained[0]] = obs.return_ready
        return results + [out]

    def _pipe_statics(self) -> None:
        """Each stage's static output activation and, past stage 0, its
        static input (the previous stage's output of the last tick), on
        the stage's device; built once."""
        if self._act_out is None:
            shape = (self.mb_size, 1, self.cfg.d_model)
            dt = self.rt.compute_dtype
            self._act_out = [torch.zeros(shape, dtype=dt, device=d)
                             for d in self.stage_devices]
            self._act_in = [None] + [torch.zeros(shape, dtype=dt, device=d)
                                     for d in self.stage_devices[1:]]

    def _state_rows(self, unit: int, mb: int) -> List[torch.Tensor]:
        """The recurrent-state rows of microbatch ``mb`` in stage
        ``unit``'s layers (``unit == n_stages``: the epilogue's)."""
        return kvc.state_rows(self.caches, mb * self.mb_size, self.mb_size,
                              self.ranges[unit])

    def _stage_step(self, s: int, mb: int) -> None:
        """The captured step of stage ``s`` on microbatch ``mb``: its
        layers from the embedded tokens (stage 0) or its static input,
        into its static output."""
        dev = self.stage_devices[s]
        inp = self._inp[dev]
        x = PL.embed_decode_tokens(self.params, inp[0], self.cfg, self.rt) \
            if s == 0 else self._act_in[s]
        y = PL.decode_stage(self.params, self.caches, x, inp[1 + s],
                            stage=s, mb=mb, cfg=self.cfg, rt=self.rt,
                            n_stages=self.n_stages, mb_size=self.mb_size,
                            device=dev)
        self._act_out[s].copy_(y)

    def _drain_step(self, mb: int, sampled: bool) -> None:
        """The captured step of the drained microbatch ``mb``: the
        epilogue, the head and the sampler on the last stage's output,
        into the static (tokens, log-probs)."""
        n, last = self.n_stages, self.stage_devices[-1]
        inp = self._inp[last]
        toks, lps = PL.decode_drain(
            self.params, self.caches, self._act_out[n - 1], inp[n], mb=mb,
            noise=self._noise if sampled else None,
            temp=inp[-2].view(torch.float32), top_k=inp[-3],
            top_p=inp[-1].view(torch.float32), sampled=sampled,
            cfg=self.cfg, rt=self.rt, n_stages=n, mb_size=self.mb_size,
            device=last, head=self.head)
        self._out[0].copy_(toks)
        self._out[1].copy_(lps)

    def transport_stats(self) -> Dict:
        return self.transport.stats()

    # -- fault injection and stage times ----------------------------------

    def _take_faults(self, plane: str, tick: int, entries: list):
        """Consume this tick's fault events.  A drop empties the stage's
        entry in ``entries`` (the tick then runs the stage as a bubble:
        no compute, no writes) and returns the lost payload, which the
        engine injects again; a delay is returned as the stage's synthetic
        seconds for the straggler mitigation."""
        delays: Dict[int, float] = {}
        lost: list = []
        if self.fault_plan is not None:
            for ev in self.fault_plan.take(plane, tick):
                if ev.kind == "drop":
                    if entries[ev.stage] is not None:
                        lost.append(entries[ev.stage])
                        entries[ev.stage] = None
                else:
                    delays[ev.stage] = delays.get(ev.stage, 0.0) + ev.delay_s
        return delays, lost

    def _record_faults(self, plane: str, lost_mbs: list,
                       delays: dict) -> None:
        """Flight-record this tick's injected faults (host-side stamps;
        callers gate on ``self.recorder is not None``)."""
        rec = self.recorder
        now = time.perf_counter()
        for m in lost_mbs:
            rec.fault("drop", now, (("plane", plane), ("mb", int(m))))
        for s, d in sorted(delays.items()):
            rec.fault("delay", now, (("plane", plane), ("stage", int(s)),
                                     ("delay_s", float(d))))

    def _observe_stages(self, dt: float, occupied: Sequence[bool],
                        delays: Dict[int, float], stalls) -> None:
        """Book one observation for each stage that ran or was delayed:
        the JAX backend's uniform share ``dt / N_S`` of the tick's seconds,
        plus the stage's injected delay, plus its link stall from the
        transport (a stage behind a slow link looks like a straggler to the
        mitigation, as the JAX backend books it).  The JAX tick runs every
        stage and books every stage; here a bubble does no work and is not
        observed, since a 0 would pull its EWMA down until the *other*
        stages read as stragglers during fill and drain.  The share stays
        ``dt / N_S`` when fewer stages ran, so a tick that runs one stage
        alone (fill, drain) reads lighter than a full one, never heavier."""
        share = dt / self.n_stages
        for s in range(self.n_stages):
            if occupied[s] or s in delays:
                self._stage_times.append(
                    (s, share + delays.get(s, 0.0) + float(stalls[s])))

    def drain_stage_times(self) -> List[tuple]:
        """``(stage, seconds)`` observations since the last call, for
        ``StragglerMitigator.observe``."""
        out, self._stage_times = self._stage_times, []
        return out

    # -- host-store migration (reshard) ------------------------------------

    def _offload_units(self) -> List[tuple]:
        """``(offloader, lo, hi)``: each stage offloader and the epilogue's
        with the layer range it swaps."""
        units = [(o, *self.ranges[s])
                 for s, o in enumerate(self.stage_offloaders)]
        if self.epilogue_offloader is not None:
            units.append((self.epilogue_offloader,
                          *self.ranges[self.n_stages]))
        return units

    def _store_layout(self):
        """``(elements, dtype, unit_range)`` of a whole-model host store
        (every paged layer in layer order, its K global slice then its V
        one): its size, and ``unit_range(lo, hi)``, the element range
        ``[a, b)`` that the paged layers among layers ``[lo, hi)`` take."""
        layers = self.caches["layers"]
        paged = [i for i, layer in enumerate(layers) if "k_pages" in layer]
        k = layers[paged[0]]["k_pages"]
        slab = self.pool.n_global_pages * k[0].numel()

        def unit_range(lo: int, hi: int):
            a = sum(1 for i in paged if i < lo)
            b = sum(1 for i in paged if i < hi)
            return 2 * a * slab, 2 * b * slab
        return 2 * len(paged) * slab, k.dtype, unit_range

    def export_offload_state(self) -> Dict[int, torch.Tensor]:
        """The offloaders' host stores as whole-model host tensors, one per
        microbatch, independent of the stage split: every paged layer of
        the model in layer order, its ``(n_global, page, Hk, Dh)`` K slice
        then its V slice, flat (pinned when the pools are on the card).
        ``import_offload_state`` cuts them up for another stage count.

        Each offloader is settled first.  A microbatch resident in a
        unit's pools is copied from the pools (the rebuilt backend's
        offloaders start with nothing resident, so their first
        ``ensure_resident`` must find every microbatch in the host store);
        a unit that never held a microbatch leaves zeros, what its
        offloader would have swapped in.  Only one host copy of the stores
        is made here; call with both planes drained."""
        units = [u for u in self._offload_units() if u[1] < u[2]]
        if not units:
            return {}
        for o, _, _ in units:
            o.settle()
        n, dtype, unit_range = self._store_layout()
        state: Dict[int, torch.Tensor] = {}
        filled: Dict[int, set] = {}         # mb -> unit ranges written

        def dst_of(mb: int, a: int, b: int) -> torch.Tensor:
            if mb not in state:
                state[mb] = torch.empty(n, dtype=dtype, pin_memory=any(
                    d.type == "cuda" for d in self._devices))
                filled[mb] = set()
            filled[mb].add((a, b))
            return state[mb][a:b]

        ranges = [unit_range(lo, hi) for _, lo, hi in units]
        for (o, lo, hi), (a, b) in zip(units, ranges):
            o.export_stores({"layers": self.caches["layers"][lo:hi]},
                            lambda mb, a=a, b=b: dst_of(mb, a, b))
        for mb, buf in state.items():
            for a, b in ranges:
                if (a, b) not in filled[mb]:
                    buf[a:b].zero_()
        self._sync()            # the resident slices' device-to-host copies
        return state

    def import_offload_state(self, state: Dict[int, torch.Tensor]) -> None:
        """Hand ``export_offload_state``'s tensors (of a backend with any
        stage count and placement) to this backend's offloaders: each takes
        its layers' range of every microbatch's tensor as that microbatch's
        host store and buffer, without a copy.  Nothing is resident in the
        fresh offloaders, so the first ``ensure_resident`` of each
        microbatch swaps its store in, on the copy stream of the offloader's
        stage device, the device that now owns those layers."""
        if not state:
            return
        _, _, unit_range = self._store_layout()
        for o, lo, hi in self._offload_units():
            a, b = unit_range(lo, hi)
            if a == b:
                continue
            view = {"layers": self.caches["layers"][lo:hi]}
            for mb, buf in state.items():
                o.import_store(view, mb, buf[a:b])


def _stage_seconds(dt: float, occupied: Sequence[bool]) -> List[float]:
    """Each stage's compute seconds in a tick of ``dt`` seconds: the tick's
    time split evenly over the stages that ran.  The JAX tick runs every
    stage (a bubble's writes are masked), so its even split over all
    ``N_S`` stages is the same split; here a bubble does no work, so a
    tick that runs one stage of two is one stage's time, not two halves
    of it."""
    n = max(1, sum(occupied))
    return [dt / n if occ else 0.0 for occ in occupied]


def make_backend(kind, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, offloader=None, n_stages: int = 2,
                 mesh=None, transport=None, schedule: str = "circular",
                 wire_dtype: str = "fp32", fault_plan=None,
                 caches: Optional[dict] = None, recorder=None):
    """Engine-side factory: ``kind`` is ``"local"``, ``"pipelined"``, or an
    already constructed backend (passed through).  Given an ``offloader``,
    the pipelined backend builds its own, one a stage, in the same swap
    mode.  ``caches`` carries an earlier backend's caches over (reshard);
    ``recorder`` is the engine's flight recorder, or None."""
    if isinstance(kind, _SlotCacheBackend):
        return kind
    if kind == "local":
        if fault_plan is not None:
            raise ValueError(
                "fault injection (FaultPlan) requires the pipelined "
                "backend — the local backend has no stages to drop")
        if transport is not None or schedule != "circular" \
                or wire_dtype != "fp32":
            raise ValueError(
                "stage transports / schedules / wire codecs require the "
                "pipelined backend — the local backend has no stage "
                "boundaries for a link to cross")
        return LocalBackend(cfg, params, rt, mb_size=mb_size,
                            num_microbatches=num_microbatches, pool=pool,
                            device=device, offloader=offloader,
                            caches=caches, recorder=recorder)
    if kind == "pipelined":
        return PipelinedBackend(
            cfg, params, rt, mb_size=mb_size,
            num_microbatches=num_microbatches, pool=pool, device=device,
            n_stages=n_stages, offload=offloader is not None,
            offload_async=offloader is None or offloader.async_swap,
            mesh=mesh, transport=transport, schedule=schedule,
            wire_dtype=wire_dtype, fault_plan=fault_plan, caches=caches,
            recorder=recorder)
    raise ValueError(f"unknown backend {kind!r} (want 'local'|'pipelined')")
