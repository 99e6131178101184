"""DeServe's §4.3 persistent circular pipeline, one tick at a time
(counterpart of the tick path of ``repro.core.pipeline``).

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
mesh: one controller, one program.  Its eager counterpart here is one
process that runs the occupied stages in turn, in stage order, on the
device's current stream, with the pools and states written in place:

- a stage runs ``models.model.run_layers`` over its own layer range on its
  entry's rows (``serving.kv_cache.slot_view``) or table rows;
- a bubble stage (no entry) does no work and writes nothing, where the
  JAX tick computes it and masks its writes (``jnp.where``);
- the ``ppermute`` of the activation becomes the next stage's input for
  the next tick: the tensor itself under ``wire_dtype="fp32"``, the per-row
  int8 round trip (``distributed.compression``) under ``"int8"``, the
  payload the transport books;
- the ``psum`` of the last stage's output becomes that output.

The host decides which stages are occupied (``mb_assign`` / ``occupied``,
host integers), so a tick needs no device-to-host transfer of its own.
The fault seam of the JAX ticks (``drop_stage``) comes with the resilience
slice of the port.  The fixed-batch passes (``pipeline_decode_step``,
``pipeline_prefill``, ``pipeline_decode_rounds``, used only by the dry run)
are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.compression import (int8_compress_rows,
                                                 int8_decompress_rows)
from repro_torch.models import embedding as embed_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime, make_layer_plan
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.sampler import greedy, sample_batched, token_logprobs

WIRE_DTYPES = ("fp32", "int8")


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


def _wire(y: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """What the next stage receives: ``y`` itself (``"fp32"``), or its
    per-row int8 round trip (``"int8"``: one float32 scale a row), as the
    JAX ``_wire_permute`` ships it."""
    if wire_dtype == "int8":
        q, scale = int8_compress_rows(y)
        return int8_decompress_rows(q, scale, y.dtype)
    return y


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


def pipeline_decode_tick(params: dict, caches: dict, act: list,
                         tokens: torch.Tensor, pos_stage: torch.Tensor, *,
                         mb_assign: Sequence[int], noise, temp, top_k, top_p,
                         sampled: bool, cfg: ModelConfig, rt: Runtime,
                         n_stages: int, mb_size: int,
                         wire_dtype: str = "fp32"):
    """Advance the persistent decode pipe by one tick.

    caches:    engine-format paged caches (``serving.kv_cache``), written
               in place.
    act:       per-stage input activations (``n_stages`` entries, each
               ``(mb_size, 1, D)`` or ``None``): ``act[s]`` feeds stage
               ``s``; stage 0 takes the embedded ``tokens`` instead.
    tokens:    (mb_size,) int32 — last tokens of the injected microbatch.
    pos_stage: (n_stages, mb_size) int32 absolute positions per stage.
    mb_assign: (n_stages,) host ints — the microbatch each stage processes
               this tick (-1 = bubble); ``mb_assign[-1]`` is the draining
               one.
    noise, temp, top_k, top_p: per-row sampling inputs of the *draining*
               microbatch (``serving.sampler.sample_batched``), captured at
               its injection; ``sampled=False`` (every row greedy) skips the
               truncation pass and ``noise`` may be ``None``.
    wire_dtype: the stage-boundary codec, ``"fp32"`` or ``"int8"``.

    Returns ``(tokens (mb_size,) int32, model logprobs (mb_size,) float32,
    new act)``; the first two are ``None`` when no microbatch drains."""
    ranges = stage_ranges(cfg, n_stages)
    _validate_tick_args(
        "pipeline_decode_tick", n_stages=n_stages, checks={
            "act": ((len(act),), (n_stages,)),
            "tokens": (tokens.shape, (mb_size,)),
            "mb_assign": ((len(mb_assign),), (n_stages,)),
            "pos_stage": (pos_stage.shape, (n_stages, mb_size)),
        })
    new_act: List[Optional[torch.Tensor]] = [None] * n_stages
    y = None
    for s in range(n_stages):
        mb = mb_assign[s]
        if mb < 0:
            continue                    # a bubble does no work
        x_in = embed_lib.embed_tokens(params["embed"], tokens[:, None], cfg,
                                      rt.compute_dtype) if s == 0 \
            else act[s]
        view = kvc.slot_view(caches, mb * mb_size, mb_size)
        y = model_lib.run_layers(params, x_in, cfg, rt, mode="decode",
                                 caches=view, positions=pos_stage[s][:, None],
                                 layers=ranges[s])
        if s < n_stages - 1:
            new_act[s + 1] = _wire(y, wire_dtype)
    out_mb = mb_assign[n_stages - 1]
    if out_mb < 0:
        return None, None, new_act
    # the draining microbatch: epilogue, final norm, unembedding, sampling
    view = kvc.slot_view(caches, out_mb * mb_size, mb_size)
    xf = _epilogue(params, y, cfg, rt, mode="decode", caches=view,
                   positions=pos_stage[n_stages - 1][:, None],
                   layers=ranges[n_stages])
    logits = model_lib.decode_logits(params, xf, cfg)
    toks = sample_batched(logits, noise, temp, top_k, top_p) if sampled \
        else greedy(logits)
    return toks, token_logprobs(logits, toks), new_act


def pipeline_prefill_chunk_tick(params: dict, caches: dict, act: list,
                                tokens: torch.Tensor,
                                offs_stage: torch.Tensor,
                                valid_stage: torch.Tensor,
                                tables_stage: torch.Tensor,
                                lasts: torch.Tensor, *,
                                occupied: Sequence[bool], cfg: ModelConfig,
                                rt: Runtime, n_stages: int,
                                wire_dtype: str = "fp32"):
    """Advance the persistent *prefill* pipe by one tick: a chunk injected
    at stage 0 overlaps the in-flight decode microbatches instead of
    pausing them.

    caches:       engine-format paged caches (every layer paged — the
                  engine sends ring and recurrent archs to exact prefill).
    act:          per-stage chunk activations (``(R, C, D)`` or ``None``).
    tokens:       (R, C) int32 — the chunk injected at stage 0 this tick.
    offs_stage:   (n_stages, R) int32 prefilled-token offsets per stage.
    valid_stage:  (n_stages, R) int32 real-token counts (0 = pad row).
    tables_stage: (n_stages, R, P) int32 per-row page-table rows (the
                  device-wide table keeps prefilling slots parked).
    lasts:        (R,) int32 within-chunk final-token index of the
                  *draining* chunk.
    occupied:     (n_stages,) host bools — which stages hold a chunk.

    Returns ``(logits (R, V) float32 of the draining chunk, or None, new
    act)``."""
    ranges = stage_ranges(cfg, n_stages)
    R, C = tokens.shape
    _validate_tick_args(
        "pipeline_prefill_chunk_tick", n_stages=n_stages, checks={
            "act": ((len(act),), (n_stages,)),
            "occupied": ((len(occupied),), (n_stages,)),
            "offs_stage": (offs_stage.shape, (n_stages, R)),
            "valid_stage": (valid_stage.shape, (n_stages, R)),
            "tables_stage": (tables_stage.shape[:2], (n_stages, R)),
            "lasts": (lasts.shape, (R,)),
        })
    new_act: List[Optional[torch.Tensor]] = [None] * n_stages
    y = None
    for s in range(n_stages):
        if not occupied[s]:
            continue
        x_in = embed_lib.embed_tokens(params["embed"], tokens, cfg,
                                      rt.compute_dtype) if s == 0 \
            else act[s]
        # the chunk's rows are arbitrary slots: the stage sees the chunk's
        # own table rows; the pools are shared and written in place
        view = {"layers": caches["layers"], "page_table": tables_stage[s]}
        pos = model_lib.chunk_positions(offs_stage[s], valid_stage[s], C)
        y = model_lib.run_layers(params, x_in, cfg, rt, mode="chunk",
                                 caches=view, positions=pos,
                                 layers=ranges[s])
        if s < n_stages - 1:
            new_act[s + 1] = _wire(y, wire_dtype)
    if not occupied[n_stages - 1]:
        return None, new_act
    tabs = tables_stage[n_stages - 1]
    pos = model_lib.chunk_positions(offs_stage[n_stages - 1],
                                    valid_stage[n_stages - 1], C)
    xf = _epilogue(params, y, cfg, rt, mode="chunk",
                   caches={"layers": caches["layers"], "page_table": tabs},
                   positions=pos, layers=ranges[n_stages])
    return model_lib.chunk_logits(params, xf, lasts, cfg), new_act
