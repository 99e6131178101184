"""DeServe's §4.3 circular pipeline (counterpart of ``repro.core.pipeline``):
the persistent pipe one tick at a time, and the fixed-batch passes.

The model's layers are split into ``n_stages`` contiguous stage slices,
aligned to the layer plan's periods as the JAX split is: stage ``s`` owns
periods ``[s·pps, (s+1)·pps)`` of ``models.common.make_layer_plan``, and the
leftover periods and the pattern tail run as the *epilogue*, with the
final norm, the unembedding and sampling, on the microbatch that drains
from the last stage.  Each engine tick injects (at most) one entry at stage
0 and advances every in-flight entry one stage: the decode plane
(``pipeline_decode_tick``) carries microbatches of ``mb_size`` cache rows,
the prefill plane (``pipeline_prefill_chunk_tick``) prompt chunks with their
own page-table rows.

The JAX package runs all stages inside one ``shard_map`` over a ``pod``
mesh: one controller, one program, one device a stage.  Its eager
counterpart here is one process that issues the occupied stages in turn,
in stage order, each on its own device (``devices``, one torch device a
stage; it may repeat one, and every stage is on the inputs' device when it
is None), with the pools and states written in place:

- stage ``s`` owns everything it reads and writes on ``devices[s]``: its
  layers' weights and caches (``models.model.place_params``,
  ``serving.kv_cache.build_paged_caches(layer_devices=)``), and its
  positions, offsets and table rows, which the caller puts there;
- a stage runs ``models.model.run_layers`` over its own layer range on its
  entry's rows (``serving.kv_cache.slot_view``) or table rows, on its
  device's current stream;
- a bubble stage (no entry) does no work and writes nothing, where the
  JAX tick computes it and masks its writes (``jnp.where``);
- the ``ppermute`` of the activation becomes the next stage's input for
  the next tick, copied to the next stage's device (``_wire``): between
  two cards a peer copy that orders itself on both devices' current
  streams, so no stage waits on the host for another and stages on
  different cards overlap; to or from the CPU a blocking copy.  Under
  ``wire_dtype="int8"`` the sender compresses each row to int8 with a
  float32 scale (``distributed.compression``), the payload and its scales
  cross, and the receiver decompresses: the bytes that cross are the ones
  the transport books;
- the ``psum`` of the last stage's output becomes that output; the
  epilogue, the final norm, the unembedding and sampling run on the last
  stage's device (a tied model's table copied there by the caller,
  ``models.model.tied_head``, and passed as ``head``).

The host decides which stages are occupied (``mb_assign`` / ``occupied``,
host integers), so a tick needs no device-to-host transfer of its own.
A decode tick is ``decode_stage`` for each occupied stage and
``decode_drain`` for the microbatch leaving the last one, a prefill tick
``chunk_stage`` (after ``embed_chunk_tokens`` at stage 0) and
``chunk_drain``; the pipelined backend captures each of them as a CUDA
graph, one a (stage, microbatch) and one a drained microbatch for
decode, one a stage and one for the drain for prefill
(``serving.step_graph``), and hands the activation on between replays.
The JAX ticks' fault seam (``drop_stage``, which masks a dropped stage's
writes) has no counterpart: the backend drops a stage by emptying its
entry, and a bubble writes nothing.

The fixed-batch passes (``pipeline_prefill``, ``pipeline_decode_step``,
``pipeline_decode_rounds``) run one whole pass of the schedule over
``N_B`` microbatches of ``mb_size`` rows (:class:`PipelineConfig`): at tick
``t`` stage ``p`` works on microbatch ``t - p``, in ``N_B + N_S - 1`` ticks
(``R·N_B + N_S - 1`` for ``R`` greedy rounds).  They own dense caches
(``init_pipeline_caches``): each stage's layers a microbatch, the
epilogue's layers over the global batch, as the JAX passes lay them out.
The same rules hold as for the ticks: the stages run in turn, each on its
device, a bubble does no work, the activation itself is the next stage's
input, copied to its device (the JAX passes ship it raw: no wire codec),
and every cache is written in place.
A stage call sees one microbatch and the epilogue of a prefill or a
decode step the whole batch, the JAX passes' call boundaries, which an
MoE layer's capacity follows.  These three functions are the eager form.
:class:`FixedPasses` runs the same passes as the counterpart of the JAX
package's jitted ones: it owns the caches and static inputs and outputs
a device, and replays a CUDA graph a stage call (``serving.step_graph``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.compression import (int8_compress_rows,
                                                 int8_decompress_rows)
from repro_torch.models import embedding as embed_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import (Runtime, make_layer_plan,
                                       resolve_device, stage_device,
                                       text_positions3)
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.sampler import greedy, sample_batched, token_logprobs
from repro_torch.serving.step_graph import StepGraphs

WIRE_DTYPES = ("fp32", "int8")


@dataclass(frozen=True)
class PipelineConfig:
    """The geometry of a fixed-batch pass."""

    n_stages: int
    n_microbatches: int
    mb_size: int                      # sequences per microbatch

    @property
    def global_batch(self) -> int:
        return self.n_microbatches * self.mb_size

    @property
    def n_ticks(self) -> int:
        return self.n_microbatches + self.n_stages - 1


def split_layers(cfg: ModelConfig, n_stages: int) -> Tuple[int, int]:
    """(periods_per_stage, leftover_periods).  Stage i owns scanned periods
    [i·pps, (i+1)·pps); the leftover periods + pattern tail are epilogue."""
    plan = make_layer_plan(cfg.num_layers, cfg.block_pattern)
    pps = plan.n_periods // n_stages
    leftover = plan.n_periods - pps * n_stages
    if pps == 0:
        raise ValueError(
            f"{cfg.name}: {plan.n_periods} periods cannot fill {n_stages} "
            "pipeline stages")
    return pps, leftover


def stage_ranges(cfg: ModelConfig, n_stages: int) -> List[Tuple[int, int]]:
    """Layer ranges ``(lo, hi)`` of the stages, then of the epilogue (empty,
    ``lo == hi``, when the stages hold every layer), in the flat layer order
    of ``models.model`` (period by period, then the tail)."""
    pps, _ = split_layers(cfg, n_stages)
    per = pps * len(cfg.block_pattern)
    ranges = [(s * per, (s + 1) * per) for s in range(n_stages)]
    return ranges + [(n_stages * per, cfg.num_layers)]


def layer_devices(cfg: ModelConfig, devices: Sequence) -> list:
    """One device a layer for a pipe over ``devices`` (one a stage): each
    stage's layers on its device, the epilogue's on the last stage's."""
    ranges = stage_ranges(cfg, len(devices))
    out = [devices[-1]] * cfg.num_layers
    for (lo, hi), dev in zip(ranges, devices):
        out[lo:hi] = [dev] * (hi - lo)
    return out


def _stage_devices(devices, default, n_stages: int) -> list:
    """The tick's or pass's device list: ``devices``, or every stage on
    ``default`` (the inputs' device)."""
    if devices is None:
        return [default] * n_stages
    if len(devices) != n_stages:
        raise ValueError(f"{len(devices)} device(s) for {n_stages} "
                         "stage(s): one device a stage")
    return list(devices)


def _wire(y: torch.Tensor, wire_dtype: str, device) -> torch.Tensor:
    """What the next stage receives, on its ``device``: ``y`` itself
    (``"fp32"``), or its per-row int8 round trip (``"int8"``: one float32
    scale a row), as the JAX ``_wire_permute`` ships it, compressed on the
    sender's device and decompressed on the receiver's."""
    if wire_dtype == "int8":
        q, scale = int8_compress_rows(y)
        return int8_decompress_rows(q.to(device), scale.to(device), y.dtype)
    return y.to(device)


def _validate_tick_args(name: str, *, n_stages: int, checks: dict) -> None:
    """Shape checks of a tick's arguments (``checks``: argument name ->
    ``(got_shape, want_shape)``); a mismatch raises at once instead of
    ticks later."""
    for arg, (got, want) in checks.items():
        if tuple(got) != tuple(want):
            raise ValueError(
                f"{name}: {arg} has shape {tuple(got)}, want "
                f"{tuple(want)} — the backend and the tick disagree on "
                f"the geometry of the {n_stages}-stage pipe")


def _epilogue(params: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
              *, mode: str, caches: dict, positions: torch.Tensor,
              layers: Tuple[int, int]) -> torch.Tensor:
    """The leftover periods and the pattern tail on the drained entry (the
    final norm follows in ``models.model.decode_logits`` /
    ``chunk_logits``)."""
    if layers[0] == layers[1]:
        return x
    return model_lib.run_layers(params, x, cfg, rt, mode=mode, caches=caches,
                                positions=positions, layers=layers)


def _rows_shape(rows) -> tuple:
    """``(n_stages,) + one row's shape`` of per-stage inputs: an
    ``(n_stages, ...)`` tensor or a list of one tensor a stage."""
    return (len(rows),) + tuple(rows[0].shape)


def pipeline_decode_tick(params: dict, caches: dict, act: list,
                         tokens: torch.Tensor, pos_stage, *,
                         mb_assign: Sequence[int], noise, temp, top_k, top_p,
                         sampled: bool, cfg: ModelConfig, rt: Runtime,
                         n_stages: int, mb_size: int,
                         wire_dtype: str = "fp32", devices=None, head=None):
    """Advance the persistent decode pipe by one tick.

    caches:    engine-format paged caches (``serving.kv_cache``), written
               in place, each layer on its stage's device.
    act:       per-stage input activations (``n_stages`` entries, each
               ``(mb_size, 1, D)`` or ``None``): ``act[s]`` feeds stage
               ``s`` and lies on its device; stage 0 takes the embedded
               ``tokens`` instead.
    tokens:    (mb_size,) int32 — last tokens of the injected microbatch,
               on stage 0's device.
    pos_stage: (n_stages, mb_size) int32 absolute positions per stage, or
               a list of one (mb_size,) row a stage on that stage's device.
    mb_assign: (n_stages,) host ints — the microbatch each stage processes
               this tick (-1 = bubble); ``mb_assign[-1]`` is the draining
               one.
    noise, temp, top_k, top_p: per-row sampling inputs of the *draining*
               microbatch (``serving.sampler.sample_batched``), captured at
               its injection, on the last stage's device; ``sampled=False``
               (every row greedy) skips the truncation pass and ``noise``
               may be ``None``.
    wire_dtype: the stage-boundary codec, ``"fp32"`` or ``"int8"``.
    devices:   one torch device a stage (None: every stage on ``tokens``'
               device).
    head:      the unembedding's table on the last stage's device where
               ``params`` does not hold it there
               (``models.model.tied_head``).

    Returns ``(tokens (mb_size,) int32, model logprobs (mb_size,) float32,
    new act)``, the first two on the last stage's device, or ``None`` when
    no microbatch drains."""
    _validate_tick_args(
        "pipeline_decode_tick", n_stages=n_stages, checks={
            "act": ((len(act),), (n_stages,)),
            "tokens": (tokens.shape, (mb_size,)),
            "mb_assign": ((len(mb_assign),), (n_stages,)),
            "pos_stage": (_rows_shape(pos_stage), (n_stages, mb_size)),
        })
    devs = _stage_devices(devices, tokens.device, n_stages)
    new_act: List[Optional[torch.Tensor]] = [None] * n_stages
    y = None
    for s in range(n_stages):
        mb = mb_assign[s]
        if mb < 0:
            continue                    # a bubble does no work
        x_in = embed_decode_tokens(params, tokens, cfg, rt) if s == 0 \
            else act[s]
        y = decode_stage(params, caches, x_in, pos_stage[s], stage=s, mb=mb,
                         cfg=cfg, rt=rt, n_stages=n_stages, mb_size=mb_size,
                         device=devs[s])
        if s < n_stages - 1:
            new_act[s + 1] = _wire(y, wire_dtype, devs[s + 1])
    out_mb = mb_assign[n_stages - 1]
    if out_mb < 0:
        return None, None, new_act
    toks, lps = decode_drain(params, caches, y, pos_stage[n_stages - 1],
                             mb=out_mb, noise=noise, temp=temp, top_k=top_k,
                             top_p=top_p, sampled=sampled, cfg=cfg, rt=rt,
                             n_stages=n_stages, mb_size=mb_size,
                             device=devs[-1], head=head)
    return toks, lps, new_act


def embed_decode_tokens(params: dict, tokens: torch.Tensor,
                        cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    """Stage 0's input of a decode tick: the (mb_size,) tokens embedded,
    (mb_size, 1, D)."""
    return embed_lib.embed_tokens(params["embed"], tokens[:, None], cfg,
                                  rt.compute_dtype)


def decode_stage(params: dict, caches: dict, x: torch.Tensor,
                 positions: torch.Tensor, *, stage: int, mb: int,
                 cfg: ModelConfig, rt: Runtime, n_stages: int, mb_size: int,
                 device=None) -> torch.Tensor:
    """One stage of a decode tick: stage ``stage``'s layers over
    microbatch ``mb``'s cache rows, with the page table's copy on
    ``device`` (stage 0's when None), from ``x`` (mb_size, 1, D) at
    ``positions`` (mb_size,) int32; returns the stage's output."""
    view = kvc.slot_view(caches, mb * mb_size, mb_size, device)
    return model_lib.run_layers(params, x, cfg, rt, mode="decode",
                                caches=view, positions=positions[:, None],
                                layers=stage_ranges(cfg, n_stages)[stage])


def decode_drain(params: dict, caches: dict, y: torch.Tensor,
                 positions: torch.Tensor, *, mb: int, noise, temp, top_k,
                 top_p, sampled: bool, cfg: ModelConfig, rt: Runtime,
                 n_stages: int, mb_size: int, device=None, head=None):
    """The microbatch ``mb`` draining from the last stage's output ``y``,
    on the last stage's ``device``: the epilogue, the final norm, the
    unembedding and sampling (as in :func:`pipeline_decode_tick`).
    Returns ``(tokens (mb_size,) int32, logprobs (mb_size,) float32)``."""
    view = kvc.slot_view(caches, mb * mb_size, mb_size, device)
    xf = _epilogue(params, y, cfg, rt, mode="decode", caches=view,
                   positions=positions[:, None],
                   layers=stage_ranges(cfg, n_stages)[n_stages])
    logits = model_lib.decode_logits(params, xf, cfg, head)
    toks = sample_batched(logits, noise, temp, top_k, top_p) if sampled \
        else greedy(logits)
    return toks, token_logprobs(logits, toks)


def pipeline_prefill_chunk_tick(params: dict, caches: dict, act: list,
                                tokens: torch.Tensor, offs_stage,
                                valid_stage, tables_stage,
                                lasts: torch.Tensor, *,
                                occupied: Sequence[bool], cfg: ModelConfig,
                                rt: Runtime, n_stages: int,
                                wire_dtype: str = "fp32", devices=None,
                                head=None):
    """Advance the persistent *prefill* pipe by one tick: a chunk injected
    at stage 0 overlaps the in-flight decode microbatches instead of
    pausing them.

    caches:       engine-format paged caches (every layer paged — the
                  engine sends ring and recurrent archs to exact prefill),
                  each layer on its stage's device.
    act:          per-stage chunk activations (``(R, C, D)`` or ``None``),
                  each on its stage's device.
    tokens:       (R, C) int32 — the chunk injected at stage 0 this tick,
                  on stage 0's device.
    offs_stage:   (n_stages, R) int32 prefilled-token offsets per stage.
    valid_stage:  (n_stages, R) int32 real-token counts (0 = pad row).
    tables_stage: (n_stages, R, P) int32 per-row page-table rows (the
                  device-wide table keeps prefilling slots parked).  These
                  three may also be lists of one row a stage, each on its
                  stage's device.
    lasts:        (R,) int32 within-chunk final-token index of the
                  *draining* chunk, on the last stage's device.
    occupied:     (n_stages,) host bools — which stages hold a chunk.
    devices:      one torch device a stage (None: every stage on
                  ``tokens``' device).
    head:         as in :func:`pipeline_decode_tick`.

    Returns ``(logits (R, V) float32 of the draining chunk, on the last
    stage's device, or None, new act)``."""
    R = tokens.shape[0]
    _validate_tick_args(
        "pipeline_prefill_chunk_tick", n_stages=n_stages, checks={
            "act": ((len(act),), (n_stages,)),
            "occupied": ((len(occupied),), (n_stages,)),
            "offs_stage": (_rows_shape(offs_stage), (n_stages, R)),
            "valid_stage": (_rows_shape(valid_stage), (n_stages, R)),
            "tables_stage": (_rows_shape(tables_stage)[:2], (n_stages, R)),
            "lasts": (lasts.shape, (R,)),
        })
    devs = _stage_devices(devices, tokens.device, n_stages)
    new_act: List[Optional[torch.Tensor]] = [None] * n_stages
    y = None
    for s in range(n_stages):
        if not occupied[s]:
            continue
        x_in = embed_chunk_tokens(params, tokens, cfg, rt) if s == 0 \
            else act[s]
        y = chunk_stage(params, caches, x_in, offs_stage[s], valid_stage[s],
                        tables_stage[s], stage=s, cfg=cfg, rt=rt,
                        n_stages=n_stages)
        if s < n_stages - 1:
            new_act[s + 1] = _wire(y, wire_dtype, devs[s + 1])
    if not occupied[n_stages - 1]:
        return None, new_act
    last = n_stages - 1
    return chunk_drain(params, caches, y, offs_stage[last],
                       valid_stage[last], tables_stage[last], lasts,
                       cfg=cfg, rt=rt, n_stages=n_stages,
                       head=head), new_act


def embed_chunk_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                       rt: Runtime) -> torch.Tensor:
    """Stage 0's input of a prefill tick: the (R, C) chunk embedded, (R, C,
    D)."""
    return embed_lib.embed_tokens(params["embed"], tokens, cfg,
                                  rt.compute_dtype)


def chunk_stage(params: dict, caches: dict, x: torch.Tensor,
                offsets: torch.Tensor, n_valid: torch.Tensor,
                tables: torch.Tensor, *, stage: int, cfg: ModelConfig,
                rt: Runtime, n_stages: int) -> torch.Tensor:
    """One stage of a prefill tick: stage ``stage``'s layers over the chunk
    ``x`` (R, C, D) at its ``offsets`` / ``n_valid`` (R,), through the
    chunk's own table rows ``tables`` (R, P), all on the stage's device;
    returns the stage's output."""
    # the chunk's rows are arbitrary slots: the stage sees the chunk's own
    # table rows; the pools are shared and written in place
    view = {"layers": caches["layers"], "page_table": tables}
    pos = model_lib.chunk_positions(offsets, n_valid, x.shape[1])
    return model_lib.run_layers(params, x, cfg, rt, mode="chunk",
                                caches=view, positions=pos,
                                layers=stage_ranges(cfg, n_stages)[stage])


def chunk_drain(params: dict, caches: dict, y: torch.Tensor,
                offsets: torch.Tensor, n_valid: torch.Tensor,
                tables: torch.Tensor, lasts: torch.Tensor, *,
                cfg: ModelConfig, rt: Runtime, n_stages: int,
                head=None) -> torch.Tensor:
    """The chunk draining from the last stage's output ``y``, on the last
    stage's device: the epilogue at the chunk's positions and table rows,
    then the logits (R, V) float32 at ``lasts`` (as in
    :func:`pipeline_prefill_chunk_tick`)."""
    pos = model_lib.chunk_positions(offsets, n_valid, y.shape[1])
    xf = _epilogue(params, y, cfg, rt, mode="chunk",
                   caches={"layers": caches["layers"], "page_table": tables},
                   positions=pos,
                   layers=stage_ranges(cfg, n_stages)[n_stages])
    return model_lib.chunk_logits(params, xf, lasts, cfg, head)


# ---------------------------------------------------------------------------
# The fixed-batch passes
# ---------------------------------------------------------------------------


def split_scan_params(params: dict, cfg: ModelConfig, n_stages: int):
    """``(stage_params, epilogue_params)``: each stage's ``((lo, hi),
    layers)``, its layer range and its weights ``params["layers"][lo:hi]``
    (the layer dicts themselves, no copy), then the epilogue's (the
    leftover periods and the tail; ``None`` when the stages hold every
    layer).  The JAX package stacks the periods' leaves per stage instead;
    the port's weights are one flat list of layers."""
    ranges = stage_ranges(cfg, n_stages)
    stages = [((lo, hi), params["layers"][lo:hi]) for lo, hi in ranges[:-1]]
    lo, hi = ranges[-1]
    return stages, (((lo, hi), params["layers"][lo:hi]) if hi > lo
                    else None)


def init_pipeline_caches(cfg: ModelConfig, pcfg: PipelineConfig,
                         capacity: int, rt: Runtime, device=None,
                         devices=None) -> dict:
    """Dense caches (``models.model._kind_cache``) for the fixed-batch
    passes, on ``device`` (``cuda`` unless asked), or placed by stage over
    ``devices`` (one device a stage: each stage's layers on its device, the
    epilogue's on the last stage's)::

        {"stage": [{"layers": [...]} for each microbatch],
         "epilogue": {"layers": [...]}}

    Each list holds ``cfg.num_layers`` entries in the flat layer order: a
    microbatch's list holds the stages' layers over its ``mb_size`` rows
    (``None`` in the epilogue's places), the epilogue's list the epilogue
    layers over the global batch (``None`` in the stages' places), as the
    JAX passes lay them out."""
    per_layer = layer_devices(cfg, [resolve_device(d) for d in
                                    _stage_devices(devices, device,
                                                   pcfg.n_stages)])
    n_staged = stage_ranges(cfg, pcfg.n_stages)[-1][0]
    kinds = cfg.layer_kinds()

    def layers(staged: bool, batch: int) -> list:
        return [model_lib._kind_cache(kind, cfg, batch, capacity, rt,
                                      per_layer[i])
                if (i < n_staged) == staged else None
                for i, kind in enumerate(kinds)]

    return {"stage": [{"layers": layers(True, pcfg.mb_size)}
                      for _ in range(pcfg.n_microbatches)],
            "epilogue": {"layers": layers(False, pcfg.global_batch)}}


def _rows(caches: dict, start: int, size: int) -> dict:
    """``size`` rows of dense caches from ``start``: views, so the layers'
    in-place writes reach the batch-wide tensors (the JAX passes'
    ``_epi_take`` / ``_epi_put``)."""
    return {"layers": [None if c is None else
                       {name: t[start:start + size] for name, t in c.items()}
                       for c in caches["layers"]]}


def _on_devices(t: torch.Tensor, devs: Sequence) -> dict:
    """``t`` on each distinct device of ``devs``: one copy a device."""
    return {d: t.to(d) for d in dict.fromkeys(devs)}


def _pipeline_pass(params: dict, caches: dict, queue: torch.Tensor,
                   positions_q: torch.Tensor, *, cfg: ModelConfig,
                   rt: Runtime, pcfg: PipelineConfig, mode: str,
                   devices=None) -> torch.Tensor:
    """One fill and drain of the circular schedule over the stages (the
    geometry, the mode and the devices are host values, keyword-only).

    queue:       (n_mb, mb, S, D) embedded microbatch inputs, on stage 0's
                 device.
    positions_q: (n_mb, mb, S), or (n_mb, 3, mb, S) with M-RoPE.
    Returns the last stage's outputs, (n_mb, mb, S, D), on its device; the
    stage caches change in place."""
    n_s, n_mb = pcfg.n_stages, pcfg.n_microbatches
    _validate_tick_args(
        "_pipeline_pass", n_stages=n_s, checks={
            "queue": (queue.shape[:2], (n_mb, pcfg.mb_size)),
            "stage caches": ((len(caches["stage"]),), (n_mb,)),
        })
    devs = _stage_devices(devices, queue.device, n_s)
    pos_on = _on_devices(positions_q, devs)
    stages, _ = split_scan_params(params, cfg, n_s)
    act: List[Optional[torch.Tensor]] = [None] * n_s
    outs: List[Optional[torch.Tensor]] = [None] * n_mb
    for t in range(pcfg.n_ticks):
        nxt: List[Optional[torch.Tensor]] = [None] * n_s
        for s, (layers, _) in enumerate(stages):
            m = t - s
            if not 0 <= m < n_mb:
                continue                # a bubble does no work
            y = model_lib.run_layers(
                params, queue[m] if s == 0 else act[s], cfg, rt, mode=mode,
                caches=caches["stage"][m], positions=pos_on[devs[s]][m],
                layers=layers)
            if s < n_s - 1:
                nxt[s + 1] = y.to(devs[s + 1])  # the ppermute downstream
            else:
                outs[m] = y             # the drained microbatch
        act = nxt
    return torch.stack(outs)


def pipeline_decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                         cur_pos: torch.Tensor, cfg: ModelConfig,
                         rt: Runtime, pcfg: PipelineConfig, devices=None):
    """One pipelined decode token for every microbatch.

    tokens (n_mb, mb) int32; cur_pos (n_mb, mb) int32 absolute positions,
    both on stage 0's device; ``devices`` one device a stage (None: all on
    ``tokens``' device), the weights placed over them
    (``models.model.place_params``) and the caches
    (``init_pipeline_caches(devices=)``).  A tied model whose last stage is
    not on stage 0's device copies its table there once a call
    (``models.model.tied_head``).
    Returns (logits (n_mb, mb, V) float32 on the last stage's device,
    caches)."""
    n_mb, mb = tokens.shape
    devs = _stage_devices(devices, tokens.device, pcfg.n_stages)
    queue = embed_lib.embed_tokens(params["embed"], tokens[..., None], cfg,
                                   rt.compute_dtype)       # (n_mb, mb, 1, D)
    positions_q = cur_pos[..., None]                       # (n_mb, mb, 1)
    if cfg.frontend == "vision_patches":
        positions_q = text_positions3(positions_q).transpose(0, 1)
    drained = _pipeline_pass(params, caches, queue, positions_q, cfg=cfg,
                             rt=rt, pcfg=pcfg, mode="decode", devices=devs)
    xf = drained.reshape(pcfg.global_batch, 1, cfg.d_model)
    pos = cur_pos.reshape(pcfg.global_batch, 1).to(devs[-1])
    if cfg.frontend == "vision_patches":
        pos = text_positions3(pos)
    xf = _epilogue(params, xf, cfg, rt, mode="decode",
                   caches=caches["epilogue"], positions=pos,
                   layers=stage_ranges(cfg, pcfg.n_stages)[-1])
    logits = model_lib.decode_logits(
        params, xf, cfg, model_lib.tied_head(params, cfg, devs[-1]))
    return logits.reshape(n_mb, mb, -1), caches


def pipeline_prefill(params: dict, inputs, caches: dict, cfg: ModelConfig,
                     rt: Runtime, pcfg: PipelineConfig, devices=None):
    """Pipelined exact-length prefill of whole prompts.

    ``inputs``: ``{"tokens": (n_mb, mb, S)}`` (or that tensor alone),
    ``{"frames": (n_mb, mb, S, D)}`` or ``{"tokens", "patches"}`` (vision),
    the (n_mb, mb) microbatch layout on the leading dims; every row is S
    long; on stage 0's device.  ``devices`` as in
    :func:`pipeline_decode_step`.  Returns (last logits (n_mb, mb, V)
    float32 on the last stage's device, caches)."""
    if isinstance(inputs, torch.Tensor):
        inputs = {"tokens": inputs}
    n_mb, mb = next(iter(inputs.values())).shape[:2]
    flat = {k: v.reshape((n_mb * mb,) + tuple(v.shape[2:]))
            for k, v in inputs.items()}
    x, positions = model_lib.embed_inputs(params, flat, cfg, rt)
    devs = _stage_devices(devices, x.device, pcfg.n_stages)
    S = x.shape[1]
    queue = x.reshape(n_mb, mb, S, cfg.d_model)
    if positions.dim() == 3:                # (3, B, S) M-RoPE
        positions_q = positions.reshape(3, n_mb, mb, S).transpose(0, 1)
    else:
        positions_q = positions.reshape(n_mb, mb, S)
    drained = _pipeline_pass(params, caches, queue, positions_q, cfg=cfg,
                             rt=rt, pcfg=pcfg, mode="prefill", devices=devs)
    xf = _epilogue(params, drained.reshape(pcfg.global_batch, S, cfg.d_model),
                   cfg, rt, mode="prefill", caches=caches["epilogue"],
                   positions=positions.to(devs[-1]),
                   layers=stage_ranges(cfg, pcfg.n_stages)[-1])
    logits = model_lib.decode_logits(
        params, xf[:, -1:], cfg, model_lib.tied_head(params, cfg, devs[-1]))
    return logits.reshape(n_mb, mb, -1), caches


def pipeline_decode_rounds(params: dict, tokens: torch.Tensor, caches: dict,
                           cur_pos: torch.Tensor, cfg: ModelConfig,
                           rt: Runtime, pcfg: PipelineConfig, *,
                           rounds: int, devices=None):
    """Greedy-decode ``rounds`` tokens a microbatch in ONE circular pass.

    This is the schedule the paper runs in steady state: microbatch ``m``'s
    round-``r`` token is injected at tick ``r·N_B + m``, right behind its
    round-``r−1`` drain (legal because N_B ≥ N_S), so the fill and drain
    bubbles amortise to (N_S−1)/(R·N_B + N_S − 1).  The epilogue, the
    greedy pick and the next embedding run on each drained microbatch's
    rows (the return link carries the (mb,) token ids to stage 0's
    device); its rows of the epilogue caches are written in place.

    tokens / cur_pos (n_mb, mb) int32 on stage 0's device; ``devices`` as
    in :func:`pipeline_decode_step`.  Returns (all tokens (rounds, n_mb,
    mb) int32 on stage 0's device, caches).  Requires N_B ≥ N_S."""
    n_s, n_mb, mb = pcfg.n_stages, pcfg.n_microbatches, pcfg.mb_size
    if n_mb < n_s:
        raise ValueError("multi-round circular decode needs N_B >= N_S")
    _validate_tick_args(
        "pipeline_decode_rounds", n_stages=n_s, checks={
            "tokens": (tokens.shape, (n_mb, mb)),
            "cur_pos": (cur_pos.shape, (n_mb, mb)),
            "stage caches": ((len(caches["stage"]),), (n_mb,)),
        })
    devs = _stage_devices(devices, tokens.device, n_s)
    stages, _ = split_scan_params(params, cfg, n_s)
    epi_layers = stage_ranges(cfg, n_s)[-1]
    head = model_lib.tied_head(params, cfg, devs[-1])
    vision = cfg.frontend == "vision_patches"
    toks = tokens.clone()
    # the positions, kept on every stage device and advanced on each
    pos_on = {d: p.clone() for d, p in _on_devices(cur_pos, devs).items()}
    outs = torch.zeros((rounds, n_mb, mb), dtype=torch.int32,
                       device=tokens.device)
    act: List[Optional[torch.Tensor]] = [None] * n_s
    for t in range(rounds * n_mb + n_s - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * n_s
        y = None
        for s, (layers, _) in enumerate(stages):
            k = t - s
            if k < 0 or k // n_mb >= rounds:
                continue                # a bubble does no work
            m = k % n_mb
            x = embed_lib.embed_tokens(params["embed"], toks[m][:, None], cfg,
                                       rt.compute_dtype) if s == 0 \
                else act[s]
            p1 = pos_on[devs[s]][m][:, None]
            y = model_lib.run_layers(
                params, x, cfg, rt, mode="decode", caches=caches["stage"][m],
                positions=text_positions3(p1) if vision else p1,
                layers=layers)
            if s < n_s - 1:
                nxt[s + 1] = y.to(devs[s + 1])
        act = nxt
        out = t - (n_s - 1)
        if out < 0 or out // n_mb >= rounds:
            continue                    # nothing drains this tick
        m, r = out % n_mb, out // n_mb
        p1 = pos_on[devs[-1]][m][:, None]
        xf = _epilogue(params, y, cfg, rt, mode="decode",
                       caches=_rows(caches["epilogue"], m * mb, mb),
                       positions=text_positions3(p1) if vision else p1,
                       layers=epi_layers)
        new = greedy(model_lib.decode_logits(params, xf, cfg, head))
        toks[m] = new
        for p in pos_on.values():
            p[m] += 1
        outs[r, m] = new
    return outs, caches


# ---------------------------------------------------------------------------
# The fixed-batch passes, captured
# ---------------------------------------------------------------------------


def clear_pipeline_caches(caches: dict) -> dict:
    """Dense pipeline caches (``init_pipeline_caches``) back to their
    initial values, in place: attention and ring positions -1, their keys
    and values 0, every recurrent state 0 except an sLSTM layer's
    normaliser ``n`` (the one 2-D ``n``), 1e-6."""
    for part in caches["stage"] + [caches["epilogue"]]:
        for layer in part["layers"]:
            for name, t in (layer or {}).items():
                if name == "pos":
                    t.fill_(-1)
                elif name == "n" and t.dim() == 2:
                    t.fill_(1e-6)
                else:
                    t.zero_()
    return caches


def _state_leaves(part: dict, layers: Tuple[int, int],
                  rows: Optional[slice] = None) -> List[torch.Tensor]:
    """The recurrent-state leaves of dense caches ``part`` in the layer
    range ``layers`` (``rows`` of each, as views): what a stage call
    changes that a second call would step again.  Attention caches and
    rings are written by position (``kv_cache.state_rows``' rule)."""
    lo, hi = layers
    return [t if rows is None else t[rows]
            for c in part["layers"][lo:hi] if c is not None and "pos" not in c
            for t in c.values()]


class FixedPasses:
    """The fixed-batch passes with every stage call replayed from a CUDA
    graph: the counterpart of the JAX package's jitted
    ``pipeline_prefill``, ``pipeline_decode_step`` and
    ``pipeline_decode_rounds``, giving the functional passes' results bit
    for bit.

    Built over the weights (placed by stage with
    ``models.model.place_params`` where ``devices`` holds several), it
    owns the dense caches (``init_pipeline_caches``, :attr:`caches`), the
    tied head's copy (``models.model.tied_head``, once), the static
    inputs and outputs on each device, and one
    ``serving.step_graph.StepGraphs`` (:attr:`graphs`).  Each step reads
    and writes only those, on one device:

    - ``("fixed-decode", s, m)`` / ``("fixed-prefill", s, m, S)``: stage
      ``s``'s layers over microbatch ``m``'s cache rows, from the static
      tokens (stage 0 of a decode, embedded in the step), the static
      embedded prompts (stage 0 of a prefill) or the stage's static input,
      at the static positions on its device, into its static output (the
      last stage's into the drained microbatch's rows);
    - ``("fixed-embed", inputs)``: a prefill's whole-batch embedding and
      positions;
    - ``("fixed-prefill-head", S)`` / ``("fixed-decode-head",)``: the
      whole-batch epilogue and head of a prefill and a decode step;
    - ``("fixed-drain", m)``: a greedy round's drain of microbatch ``m``
      (the epilogue on its rows, the head, the greedy pick into the static
      token slot, its positions advanced).

    The Python tick loop stays: it replays the steps and hands each
    stage's output to the next stage's static input between replays (a
    copy, across devices where the stages' differ), and puts a drained
    token where stage 0 and the result read it.  A key is captured at its
    first call, after a warm-up whose recurrent-state rows are copied
    aside and back; on the CPU the same steps run eagerly.  A prefill
    starts the recurrent layers from the states it finds: :meth:`reset`
    clears the caches in place before a new batch."""

    def __init__(self, params: dict, cfg: ModelConfig, rt: Runtime,
                 pcfg: PipelineConfig, capacity: int, devices=None,
                 device=None):
        self.params, self.cfg, self.rt, self.pcfg = params, cfg, rt, pcfg
        self.devices = [stage_device(d) for d in _stage_devices(
            devices, device, pcfg.n_stages)]
        self.caches = init_pipeline_caches(cfg, pcfg, capacity, rt,
                                           devices=self.devices)
        self.head = model_lib.tied_head(params, cfg, self.devices[-1])
        self.graphs = StepGraphs()
        self._ranges = stage_ranges(cfg, pcfg.n_stages)
        self._vision = cfg.frontend == "vision_patches"
        first, last = self.devices[0], self.devices[-1]
        i32 = dict(dtype=torch.int32)
        shape = (pcfg.n_microbatches, pcfg.mb_size)
        # stage 0's tokens and the drained ones (one tensor on one device)
        self._tok = {d: torch.zeros(shape, device=d, **i32)
                     for d in dict.fromkeys((first, last))}
        # a decode's positions, one copy a device
        self._pos = {d: torch.zeros(shape, device=d, **i32)
                     for d in dict.fromkeys(self.devices)}
        self._seqs: dict = {}           # "decode" / S -> activations, logits
        self._raw: dict = {}            # prefill input signature -> inputs

    # -- static tensors -----------------------------------------------------

    def _seq(self, S):
        """The static activations, positions and logits of a decode
        (``S == "decode"``) or of ``S``-token prefills, made at first
        use."""
        if S in self._seqs:
            return self._seqs[S]
        cfg, pcfg, devs = self.cfg, self.pcfg, self.devices
        n_mb, mb = pcfg.n_microbatches, pcfg.mb_size
        L = 1 if S == "decode" else S
        act = dict(dtype=self.rt.compute_dtype)
        seq = {"out": [torch.zeros((mb, L, cfg.d_model), device=d, **act)
                       for d in devs[:-1]],
               "in": [None] + [torch.zeros((mb, L, cfg.d_model), device=d,
                                           **act) for d in devs[1:]],
               "drained": torch.zeros((n_mb, mb, L, cfg.d_model),
                                      device=devs[-1], **act),
               "logits": torch.zeros((n_mb, mb, cfg.vocab_size),
                                     dtype=torch.float32, device=devs[-1])}
        if S != "decode":
            pos = (n_mb, 3, mb, S) if self._vision else (n_mb, mb, S)
            seq["queue"] = torch.zeros((n_mb, mb, S, cfg.d_model),
                                       device=devs[0], **act)
            seq["pos"] = {d: torch.zeros(pos, dtype=torch.int64, device=d)
                          for d in dict.fromkeys(devs)}
        self._seqs[S] = seq
        return seq

    def _prompt_len(self, inputs: dict) -> int:
        """The embedded length of ``inputs`` (``models.model.embed_inputs``'
        branches)."""
        if self.cfg.frontend == "audio_frames" and "frames" in inputs:
            return inputs["frames"].shape[2]
        if self._vision and "patches" in inputs:
            return inputs["patches"].shape[2] + inputs["tokens"].shape[2]
        return inputs["tokens"].shape[2]

    # -- the steps ------------------------------------------------------------

    def _stage(self, s: int, m: int, S) -> None:
        """Stage ``s`` over microbatch ``m`` of a decode or an S-token
        prefill (a graph a key)."""
        dev, seq = self.devices[s], self._seq(S)
        decode = S == "decode"
        if s > 0:
            x = seq["in"][s]
        elif decode:
            x = embed_decode_tokens(self.params, self._tok[dev][m], self.cfg,
                                    self.rt)
        else:
            x = seq["queue"][m]
        if decode:
            p1 = self._pos[dev][m][:, None]
            positions = text_positions3(p1) if self._vision else p1
        else:
            positions = seq["pos"][dev][m]
        y = model_lib.run_layers(
            self.params, x, self.cfg, self.rt,
            mode="decode" if decode else "prefill",
            caches=self.caches["stage"][m], positions=positions,
            layers=self._ranges[s])
        (seq["drained"][m] if s == self.pcfg.n_stages - 1
         else seq["out"][s]).copy_(y)

    def _embed(self, sig: tuple, S: int) -> None:
        """A prefill's embedding and positions over the whole batch into
        stage 0's static queue and positions."""
        n_mb, mb = self.pcfg.n_microbatches, self.pcfg.mb_size
        seq = self._seq(S)
        x, positions = model_lib.embed_inputs(self.params, self._raw[sig],
                                              self.cfg, self.rt)
        seq["queue"].copy_(x.reshape(n_mb, mb, S, self.cfg.d_model))
        if positions.dim() == 3:            # (3, B, S) M-RoPE
            pq = positions.reshape(3, n_mb, mb, S).transpose(0, 1)
        else:
            pq = positions.reshape(n_mb, mb, S)
        seq["pos"][self.devices[0]].copy_(pq)

    def _prefill_head(self, S: int) -> None:
        """The whole-batch epilogue and head of an S-token prefill."""
        B, D = self.pcfg.global_batch, self.cfg.d_model
        seq = self._seq(S)
        pq = seq["pos"][self.devices[-1]]
        positions = pq.transpose(0, 1).reshape(3, B, S) if pq.dim() == 4 \
            else pq.reshape(B, S)
        xf = _epilogue(self.params, seq["drained"].reshape(B, S, D),
                       self.cfg, self.rt, mode="prefill",
                       caches=self.caches["epilogue"], positions=positions,
                       layers=self._ranges[-1])
        logits = model_lib.decode_logits(self.params, xf[:, -1:], self.cfg,
                                         self.head)
        seq["logits"].copy_(logits.reshape(seq["logits"].shape))

    def _decode_head(self) -> None:
        """The whole-batch epilogue and head of a decode step."""
        B, D = self.pcfg.global_batch, self.cfg.d_model
        seq = self._seq("decode")
        pos = self._pos[self.devices[-1]].reshape(B, 1)
        if self._vision:
            pos = text_positions3(pos)
        xf = _epilogue(self.params, seq["drained"].reshape(B, 1, D),
                       self.cfg, self.rt, mode="decode",
                       caches=self.caches["epilogue"], positions=pos,
                       layers=self._ranges[-1])
        logits = model_lib.decode_logits(self.params, xf, self.cfg,
                                         self.head)
        seq["logits"].copy_(logits.reshape(seq["logits"].shape))

    def _drain(self, m: int) -> None:
        """A greedy round's drain of microbatch ``m``: the epilogue on its
        rows, the head, the greedy token into the static slot the result
        and stage 0 read, its positions on this device advanced."""
        dev, mb = self.devices[-1], self.pcfg.mb_size
        p1 = self._pos[dev][m][:, None]
        xf = _epilogue(self.params, self._seq("decode")["drained"][m],
                       self.cfg, self.rt, mode="decode",
                       caches=_rows(self.caches["epilogue"], m * mb, mb),
                       positions=text_positions3(p1) if self._vision else p1,
                       layers=self._ranges[-1])
        new = greedy(model_lib.decode_logits(self.params, xf, self.cfg,
                                             self.head))
        self._tok[dev][m].copy_(new)
        self._pos[dev][m] += 1

    # -- what each step steps again (for the warm-up's restore) --------------

    def _stage_state(self, s: int, m: int) -> list:
        return _state_leaves(self.caches["stage"][m], self._ranges[s])

    def _head_state(self) -> list:
        return _state_leaves(self.caches["epilogue"], self._ranges[-1])

    def _drain_state(self, m: int) -> list:
        mb = self.pcfg.mb_size
        return _state_leaves(self.caches["epilogue"], self._ranges[-1],
                             slice(m * mb, (m + 1) * mb)) + \
            [self._pos[self.devices[-1]][m]]

    # -- the passes -------------------------------------------------------------

    def stage_call(self, s: int, m: int, S="decode") -> None:
        """Stage ``s`` over microbatch ``m`` of a decode (or of an
        ``S``-token prefill), replayed from its graph on a card (captured
        at its first call): what each tick of a pass runs."""
        key = ("fixed-decode", s, m) if S == "decode" else \
            ("fixed-prefill", s, m, S)
        self.graphs.run(key, self.devices[s], partial(self._stage, s, m, S),
                        state=partial(self._stage_state, s, m))

    def drain_call(self, m: int) -> None:
        """A greedy round's drain of microbatch ``m``, replayed from its
        graph on a card (captured at its first call)."""
        self.graphs.run(("fixed-drain", m), self.devices[-1],
                        partial(self._drain, m),
                        state=partial(self._drain_state, m))

    def _hand_on(self, seq: dict, ran: Sequence[int]) -> None:
        """Each stage that ran hands its output to the next stage's static
        input for the next tick (the ppermute), after every stage of the
        tick read its own."""
        for s in ran:
            if s < self.pcfg.n_stages - 1:
                seq["in"][s + 1].copy_(seq["out"][s])

    def _pass(self, S) -> None:
        """One fill and drain of the schedule (``_pipeline_pass``): at tick
        ``t`` stage ``s`` calls microbatch ``t - s``, a decode's (``S ==
        "decode"``) or an S-token prefill's; the last stage's outputs land
        in the drained rows."""
        pcfg, seq = self.pcfg, self._seq(S)
        for t in range(pcfg.n_ticks):
            ran = [s for s in range(pcfg.n_stages)
                   if 0 <= t - s < pcfg.n_microbatches]
            for s in ran:
                self.stage_call(s, t - s, S)
            self._hand_on(seq, ran)

    def _load_decode(self, tokens: torch.Tensor,
                     cur_pos: torch.Tensor) -> None:
        shape = (self.pcfg.n_microbatches, self.pcfg.mb_size)
        _validate_tick_args("FixedPasses", n_stages=self.pcfg.n_stages,
                            checks={"tokens": (tokens.shape, shape),
                                    "cur_pos": (cur_pos.shape, shape)})
        self._tok[self.devices[0]].copy_(tokens)
        for p in self._pos.values():
            p.copy_(cur_pos)

    def reset(self) -> None:
        """Clear the caches in place (``clear_pipeline_caches``), before a
        new batch's prefill."""
        clear_pipeline_caches(self.caches)

    def prefill(self, inputs) -> torch.Tensor:
        """``pipeline_prefill`` on the held caches: ``inputs`` as there
        (``{"tokens"}``, ``{"frames"}`` or ``{"tokens", "patches"}``, or a
        tokens tensor, (n_mb, mb, ...) leading).  Returns the last logits
        (n_mb, mb, V) float32 on the last stage's device (a copy)."""
        if isinstance(inputs, torch.Tensor):
            inputs = {"tokens": inputs}
        pcfg, devs = self.pcfg, self.devices
        S = self._prompt_len(inputs)
        sig = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(inputs.items()))
        raw = self._raw.get(sig)
        if raw is None:
            raw = self._raw[sig] = {
                k: torch.zeros((pcfg.global_batch,) + tuple(v.shape[2:]),
                               dtype=v.dtype, device=devs[0])
                for k, v in inputs.items()}
        for k, v in inputs.items():
            raw[k].copy_(v.reshape(raw[k].shape))
        seq = self._seq(S)
        self.graphs.run(("fixed-embed", sig), devs[0],
                        partial(self._embed, sig, S))
        for d, p in seq["pos"].items():
            if d != devs[0]:
                p.copy_(seq["pos"][devs[0]])
        self._pass(S)
        self.graphs.run(("fixed-prefill-head", S), devs[-1],
                        partial(self._prefill_head, S),
                        state=self._head_state)
        return seq["logits"].clone()

    def decode_step(self, tokens: torch.Tensor,
                    cur_pos: torch.Tensor) -> torch.Tensor:
        """``pipeline_decode_step`` on the held caches: tokens / cur_pos
        (n_mb, mb) int32.  Returns the logits (n_mb, mb, V) float32 on the
        last stage's device (a copy)."""
        self._load_decode(tokens, cur_pos)
        self._pass("decode")
        self.graphs.run(("fixed-decode-head",), self.devices[-1],
                        self._decode_head, state=self._head_state)
        return self._seq("decode")["logits"].clone()

    def decode_rounds(self, tokens: torch.Tensor, cur_pos: torch.Tensor, *,
                      rounds: int) -> torch.Tensor:
        """``pipeline_decode_rounds`` on the held caches: ``rounds`` greedy
        tokens a microbatch in one circular pass.  Returns every token
        (rounds, n_mb, mb) int32 on stage 0's device.  Requires N_B >=
        N_S."""
        pcfg, devs = self.pcfg, self.devices
        n_s, n_mb = pcfg.n_stages, pcfg.n_microbatches
        if n_mb < n_s:
            raise ValueError("multi-round circular decode needs N_B >= N_S")
        self._load_decode(tokens, cur_pos)
        seq = self._seq("decode")
        tok_in, tok_out = self._tok[devs[0]], self._tok[devs[-1]]
        outs = torch.zeros((rounds, n_mb, pcfg.mb_size), dtype=torch.int32,
                           device=devs[0])
        for t in range(rounds * n_mb + n_s - 1):
            ran = [s for s in range(n_s)
                   if t - s >= 0 and (t - s) // n_mb < rounds]
            for s in ran:
                self.stage_call(s, (t - s) % n_mb, "decode")
            self._hand_on(seq, ran)
            k = t - (n_s - 1)
            if k < 0 or k // n_mb >= rounds:
                continue                    # nothing drains this tick
            m = k % n_mb
            self.drain_call(m)
            # the return link: the token to the result and to stage 0, the
            # positions advanced on the other devices
            outs[k // n_mb, m].copy_(tok_out[m])
            if tok_in is not tok_out:
                tok_in[m].copy_(tok_out[m])
            for d, p in self._pos.items():
                if d != devs[-1]:
                    p[m] += 1
        return outs
