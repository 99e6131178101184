"""The dry run: every (arch x shape x mesh) cell traced on meta tensors
(counterpart of ``repro.launch.dryrun``).

For each cell this builds meta-device stand-ins (``torch.device("meta")``:
shapes and dtypes, no storage) for the parameters, optimizer state, caches
and inputs, runs the cell's program on them once under a counting mode,
and records, for the H100:

  * ``flops_per_device`` — aten's flops (``FlopCounterMode``'s formulas:
    the matmuls, forward and backward) plus the hand-written kernels' flops
    from ``kernels.cost`` (no aten op, so the flop counter cannot see
    them), as the global count over ``n_devices`` (an even split);
  * ``bytes_per_device`` — each op's operand and output bytes (the
    counterpart of XLA's "bytes accessed"; views and empty allocations
    move none; an in-place op reads its other operands and writes as many
    bytes into its target, or reads and writes the target when it has no
    other), plus the kernels' bytes, again over ``n_devices``;
  * ``memory`` — ``argument_bytes``, what one device holds of the
    arguments by the sharding rules (``distributed.sharding``);
    ``temp_bytes``, the traced peak of every storage the program makes
    (tracked by storage: a tensor the autograd graph keeps lives until
    its storage dies), over ``n_devices``; their sum
    ``peak_per_device``, and whether it fits one H100's 80 GB;
  * ``roofline`` — compute and memory seconds at the H100's peak rates
    for the cell's dtype (``kernels.cost``), the dominant term and the
    bound ``bound_step_s``;
  * ``pod_boundary_bytes`` — on a multi-pod serving cell, the bytes of
    every stage-to-stage activation handoff the passes make (all devices
    together), counted from the schedule; ``collectives`` is None: the
    JAX dry run parses XLA's partitioned HLO for its collectives, and the
    port has no SPMD partitioner to parse (ROADMAP: the HLO parsers are
    not ported).

Each cell's program is the one the JAX dry run lowers: ``train_*`` ->
``training.train_loop.make_train_step`` (the MoE archs with bf16 moments
and 4 accumulation steps); ``prefill_*`` -> ``models.model.prefill`` on
one pod, ``core.pipeline.pipeline_prefill`` on two (the pod axis is the
stage axis); ``decode_*`` / ``long_*`` -> ``models.model.decode_step`` on
dense caches, or ``pipeline_decode_step`` (``pipeline_decode_rounds`` for
the ``rounds8`` variant).  Records go to ``experiments/dryrun_torch/``.

Nothing is allocated, so the table runs on the CPU.  ``--check`` runs the
one-card cells (``CHECKS``) for real on the card after predicting them,
and holds the prediction to what the card counts and allocates.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k --mesh multi
  python -m repro_torch.launch.dryrun --all [--jobs 4]
  python -m repro_torch.launch.dryrun --check            # needs the card
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.config import (SHAPES, MeshConfig, ModelConfig, ShapeConfig,
                                get_arch, list_archs)
from repro_torch.core import pipeline as pipe_lib
from repro_torch.distributed import sharding as shard_lib
from repro_torch.kernels import cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime, resolve_device
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
ONE_CARD = MeshConfig("one_card", (1, 1), ("data", "model"))

# --variant transforms of the JAX dry run.  The port takes "kv_dtype" and
# the serve variants' microbatch and round counts; "train_style",
# "sequence_parallel" and "causal_scheme" shape XLA's SPMD program and
# are not ported (ROADMAP, decisions that stand), so a variant made of
# nothing else raises
VARIANTS = {
    "": {},
    "zero3": dict(train_style="zero3", sequence_parallel=False),
    "blockpair": dict(causal_scheme="blockpair"),
    "int8kv": dict(kv_dtype="int8"),
    "nb8": dict(),                       # serve: 8 microbatches
    "nb8_int8": dict(kv_dtype="int8"),
    "zero3_accum2": dict(train_style="zero3", sequence_parallel=False),
    "zero3_blockpair": dict(train_style="zero3", sequence_parallel=False,
                            causal_scheme="blockpair"),
    "rounds8": dict(kv_dtype="int8"),    # multi-round circular decode, R=8
    "opt": dict(),
}
UNPORTED_KNOBS = ("train_style", "sequence_parallel", "causal_scheme")


def _variant_knobs(kind: str, variant: str) -> dict:
    kw = dict(VARIANTS[variant])
    if variant == "opt":
        kw = (dict(train_style="zero3", sequence_parallel=False)
              if kind == "train" else dict(kv_dtype="int8"))
        kw["causal_scheme"] = "blockpair"
    if kw and all(k in UNPORTED_KNOBS for k in kw):
        raise NotImplementedError(
            f"variant {variant!r} on a {kind} cell sets only "
            f"{sorted(kw)}, XLA SPMD knobs the port does not have (ROADMAP: "
            "TPU/XLA knobs not ported)")
    return {k: v for k, v in kw.items() if k not in UNPORTED_KNOBS}


def runtime_for(kind: str, variant: str = "") -> Runtime:
    """The JAX dry run's runtime: bf16 weights and activations, each layer
    recomputed in a training backward, the loss in 512-token chunks, the
    training MoE dispatch in 65,536-token chunks."""
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 remat=(kind == "train"), vocab_chunk=512, moe_chunk=65536)
    kw = _variant_knobs(kind, variant)
    return dataclasses.replace(rt, **kw) if kw else rt


def serve_pipeline_config(shape: ShapeConfig, n_stages: int = 2,
                          variant: str = "") -> pipe_lib.PipelineConfig:
    """The JAX dry run's microbatching of a serving shape: at most 4
    microbatches (8 for the nb8 / opt variants) dividing the batch,
    preferring 16-row microbatches so activations split over "data"."""
    gb = shape.global_batch
    cap = 8 if variant in ("nb8", "nb8_int8", "opt") else 4
    n_mb = min(cap, gb) if gb >= n_stages else 1
    while gb % n_mb:
        n_mb -= 1
    while n_mb > 1 and (gb // n_mb) % 16 != 0 and gb % (n_mb - 1) == 0:
        n_mb -= 1
    if (gb // n_mb) % 16 != 0 and gb >= 16 * n_stages:
        n_mb = gb // 16
    return pipe_lib.PipelineConfig(n_stages=n_stages, n_microbatches=n_mb,
                                   mb_size=gb // n_mb)


# ---------------------------------------------------------------------------
# Inputs and cells
# ---------------------------------------------------------------------------


def batch_inputs(cfg: ModelConfig, shape: ShapeConfig, *,
                 include_labels: bool, device="meta", seed: int = 0) -> dict:
    """The input dict of one arch x shape: tokens (int32), audio frames or
    vision patches (bf16) as the front end takes them, and labels.  Empty
    on meta; elsewhere drawn from ``seed``."""
    B, S = shape.global_batch, shape.seq_len
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)

    def ints(shp):
        if gen is None:
            return torch.empty(shp, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, shp, generator=gen,
                             device=device, dtype=torch.int32)

    def floats(shp):
        if gen is None:
            return torch.empty(shp, dtype=torch.bfloat16, device=device)
        return torch.randn(shp, generator=gen, device=device).to(
            torch.bfloat16)

    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = floats((B, S, cfg.d_model))
        label_len = S
    elif cfg.frontend == "vision_patches":
        pk = cfg.num_patch_tokens
        st = max(8, S - pk)
        out["tokens"] = ints((B, st))
        out["patches"] = floats((B, pk, cfg.d_model))
        label_len = st
    else:
        out["tokens"] = ints((B, S))
        label_len = S
    if include_labels:
        out["labels"] = ints((B, label_len))
    return out


@dataclass
class Cell:
    """One program and its arguments: ``fn(*args)`` runs it; ``specs``
    holds a spec tree for each argument (``distributed.sharding``)."""

    fn: Callable
    args: tuple
    specs: tuple
    mesh: MeshConfig
    dtype: str                        # compute dtype, for the peak rate
    tokens_per_step: int
    kv_dtype: str = "bf16"
    handoff_bytes: int = 0            # stage-to-stage activations


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def train_cell(cfg: ModelConfig, rt: Runtime, ocfg: opt_lib.AdamWConfig,
               batch: int, seq: int, mesh: MeshConfig, *, accum: int = 1,
               device="meta", params=None, seed: int = 0) -> Cell:
    """One ``make_train_step`` step: loss, gradients and AdamW, the batch
    in ``accum`` accumulation steps; FSDP over "data"."""
    device = resolve_device(device)
    params = model_lib.init_params(cfg, seed, rt, device) \
        if params is None else params
    opt_state = opt_lib.init(ocfg, params)
    sub = ShapeConfig("train", seq, batch // accum, "train")
    inputs = batch_inputs(cfg, sub, include_labels=True, device=device,
                          seed=seed)
    bspecs = shard_lib.batch_specs(inputs, mesh)
    if accum > 1:
        inputs = {k: torch.stack([v] * accum) if device.type != "meta" else
                  torch.empty((accum,) + tuple(v.shape), dtype=v.dtype,
                              device=device) for k, v in inputs.items()}
        bspecs = {k: (None,) + sp for k, sp in bspecs.items()}
    pspecs = shard_lib.param_specs(params, cfg, mesh, fsdp=True)
    step = make_train_step(cfg, rt, ocfg, accum_steps=accum)
    return Cell(step, (params, opt_state, inputs),
                (pspecs, shard_lib.opt_state_specs(pspecs), bspecs), mesh,
                _dtype_name(rt.compute_dtype), batch * seq, rt.kv_dtype)


def serve_2d(cfg: ModelConfig, rt: Runtime, cache_bytes: int,
             mesh: MeshConfig) -> bool:
    """Whether one-pod serving splits the weights' second dim over "data"
    too: only when the tensor-parallel weights alone (a 1/model share of
    every parameter) exceed what one H100 holds beside the cell's caches.
    The JAX dry run's test, weights over 10e9 bytes a chip, was sized for
    a TPU v5e's 16 GB; the rule here is the same question for 80 GB."""
    esize = torch.empty((), dtype=rt.param_dtype).element_size()
    md = shard_lib.mesh_shape(mesh).get("model", 1)
    return cfg.param_count() * esize / md > cost.HBM_BYTES - cache_bytes


def prefill_cell(cfg: ModelConfig, rt: Runtime, batch: int, seq: int,
                 mesh: MeshConfig, *, device="meta", params=None,
                 seed: int = 0) -> Cell:
    """``models.model.prefill`` of whole prompts; its dense caches of
    ``seq`` slots are made inside the program."""
    device = resolve_device(device)
    shape = ShapeConfig("prefill", seq, batch, "prefill")
    caches = model_lib.init_caches(cfg, batch, seq, rt, "meta")
    cache_bytes = shard_lib.per_device_bytes(
        caches, shard_lib.cache_specs(caches, cfg, mesh), mesh)
    params = model_lib.init_params(cfg, seed, rt, device) \
        if params is None else params
    inputs = batch_inputs(cfg, shape, include_labels=False, device=device,
                          seed=seed)
    pspecs = shard_lib.param_specs(
        params, cfg, mesh, fsdp=serve_2d(cfg, rt, cache_bytes, mesh))

    def fn(p, b):
        with torch.no_grad():
            return model_lib.prefill(p, b, cfg, rt, seq)

    return Cell(fn, (params, inputs),
                (pspecs, shard_lib.batch_specs(inputs, mesh)), mesh,
                _dtype_name(rt.compute_dtype), shape.tokens_per_step,
                rt.kv_dtype)


def decode_cell(cfg: ModelConfig, rt: Runtime, batch: int, capacity: int,
                mesh: MeshConfig, *, device="meta", params=None,
                seed: int = 0) -> Cell:
    """One ``models.model.decode_step`` for ``batch`` rows against dense
    caches of ``capacity`` slots, at the last slot."""
    device = resolve_device(device)
    caches = model_lib.init_caches(cfg, batch, capacity, rt, device)
    cspecs = shard_lib.cache_specs(caches, cfg, mesh)
    params = model_lib.init_params(cfg, seed, rt, device) \
        if params is None else params
    pspecs = shard_lib.param_specs(params, cfg, mesh, fsdp=serve_2d(
        cfg, rt, shard_lib.per_device_bytes(caches, cspecs, mesh), mesh))
    tokens = torch.zeros((batch,), dtype=torch.int32, device=device)
    cur = torch.full((batch,), capacity - 1, dtype=torch.int32,
                     device=device)
    tspec = ("data",) if batch % shard_lib.mesh_shape(mesh)["data"] == 0 \
        else (None,)

    def fn(p, t, c, cp):
        with torch.no_grad():
            return model_lib.decode_step(p, t, c, cp, cfg, rt)

    return Cell(fn, (params, tokens, caches, cur),
                (pspecs, tspec, cspecs, tspec), mesh,
                _dtype_name(rt.compute_dtype), batch, rt.kv_dtype)


def pipe_cell(cfg: ModelConfig, rt: Runtime, pcfg: pipe_lib.PipelineConfig,
              seq: int, capacity: int, mesh: MeshConfig, *,
              prefill: bool, decode_steps: int = 0, rounds: int = 0,
              device="meta", params=None, seed: int = 0) -> Cell:
    """The fixed-batch passes on the pipeline's dense caches: a
    ``pipeline_prefill`` of (n_mb, mb, seq) prompts when ``prefill``, then
    ``decode_steps`` ``pipeline_decode_step``s at position ``seq`` and,
    with ``rounds``, one ``pipeline_decode_rounds`` pass.  The weights stay
    whole over "pod" and "data", as the JAX dry run gives them; the stage
    caches split by the pipeline rules."""
    device = resolve_device(device)
    n_mb, mb = pcfg.n_microbatches, pcfg.mb_size
    params = model_lib.init_params(cfg, seed, rt, device) \
        if params is None else params
    caches = pipe_lib.init_pipeline_caches(cfg, pcfg, capacity, rt, device)
    inputs = None
    if prefill:
        flat = batch_inputs(cfg, ShapeConfig("p", seq, n_mb * mb, "prefill"),
                            include_labels=False, device=device, seed=seed)
        inputs = {k: v.reshape((n_mb, mb) + tuple(v.shape[1:]))
                  for k, v in flat.items()}
    tokens = torch.zeros((n_mb, mb), dtype=torch.int32, device=device)
    cur = torch.full((n_mb, mb), seq, dtype=torch.int32, device=device)
    split = mb % shard_lib.mesh_shape(mesh)["data"] == 0
    lead = (None, "data") if split else (None, None)
    ispecs = None if inputs is None else {
        k: lead + (None,) * (v.dim() - 2) for k, v in inputs.items()}

    def fn(p, b, c, t, cp):
        with torch.no_grad():
            out = None
            if b is not None:
                out, c = pipe_lib.pipeline_prefill(p, b, c, cfg, rt, pcfg)
            for _ in range(decode_steps):
                out, c = pipe_lib.pipeline_decode_step(p, t, c, cp, cfg, rt,
                                                       pcfg)
            if rounds:
                out, c = pipe_lib.pipeline_decode_rounds(
                    p, t, c, cp, cfg, rt, pcfg, rounds=rounds)
            return out

    esize = torch.empty((), dtype=rt.compute_dtype).element_size()
    per_pass = (pcfg.n_stages - 1) * n_mb * mb * cfg.d_model * esize
    handoffs = per_pass * ((seq if prefill else 0) + decode_steps
                           + rounds)
    tokens_per_step = n_mb * mb * ((seq if prefill else 0) + decode_steps
                                   + rounds)
    return Cell(fn, (params, inputs, caches, tokens, cur),
                (shard_lib.param_specs(params, cfg, mesh, fsdp=False), ispecs,
                 shard_lib.cache_specs(caches, cfg, mesh),
                 lead, lead), mesh, _dtype_name(rt.compute_dtype),
                tokens_per_step, rt.kv_dtype, handoffs)


def build_cell(arch: str, shape_name: str, mesh_name: str,
               variant: str = "", seq: int = 0) -> Cell:
    """The cell the JAX dry run builds for arch x shape x mesh, on meta
    (at ``seq`` positions instead of the shape's when given)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if seq:
        shape = dataclasses.replace(shape, seq_len=seq)
    multi = mesh_name == "multi_pod"
    mesh = make_production_mesh(multi_pod=multi)
    rt = runtime_for(shape.kind, variant)
    if shape.kind == "train":
        # bf16 moments and 4 accumulation steps for the MoE giants, as the
        # JAX dry run sizes them; the dense archs keep float32 moments
        ocfg = opt_lib.AdamWConfig(
            moment_dtype=torch.bfloat16 if cfg.moe is not None
            else torch.float32)
        accum = 4 if cfg.moe is not None else 1
        return train_cell(cfg, rt, ocfg, shape.global_batch, shape.seq_len,
                          mesh, accum=accum)
    if not multi:
        if shape.kind == "prefill":
            return prefill_cell(cfg, rt, shape.global_batch, shape.seq_len,
                                mesh)
        return decode_cell(cfg, rt, shape.global_batch, shape.seq_len, mesh)
    pcfg = serve_pipeline_config(shape, variant=variant)
    if shape.kind == "prefill":
        return pipe_cell(cfg, rt, pcfg, shape.seq_len, shape.seq_len, mesh,
                         prefill=True)
    rounds = 8 if variant == "rounds8" and pcfg.n_microbatches >= 2 else 0
    return pipe_cell(cfg, rt, pcfg, shape.seq_len - 1, shape.seq_len, mesh,
                     prefill=False, decode_steps=0 if rounds else 1,
                     rounds=rounds)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


def _tensors(x):
    """The tensors among an op's arguments (lists of them included)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh}
_OP_INFO: dict = {}


def _op_info(func):
    """(moves bytes, the arguments it writes in place as (position, name),
    the flop formula or None, whether its outputs are fresh tensors) of an
    aten op, looked up once."""
    info = _OP_INFO.get(func)
    if info is None:
        written = tuple((i, a.name) for i, a in
                        enumerate(func._schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        fresh = not func.is_view and not written and all(
            r.alias_info is None for r in func._schema.returns)
        info = (not func.is_view and func.overloadpacket not in _NO_TRAFFIC,
                written, flop_registry.get(func.overloadpacket), fresh)
        _OP_INFO[func] = info
    return info


_PLAIN = frozenset((int, float, bool, str, type(None), torch.dtype,
                    torch.device, torch.layout, torch.memory_format))
_META_OUT: dict = {}


def _walk_args(x, tensors: list, unknown: list):
    """One pass over an op's arguments: collect the tensors, and return a
    hashable description that fixes the outputs' shapes, strides and
    dtypes on meta (``unknown`` gets an entry for a tensor off meta or an
    argument of a kind it does not know)."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        if x.device.type != "meta":
            unknown.append(x)
        return (x.shape, x.stride(), x.dtype)
    t = type(x)
    if t is list or t is tuple:
        return (t, tuple(_walk_args(y, tensors, unknown) for y in x))
    if t not in _PLAIN:
        unknown.append(x)
    return (t, x)


def _meta_shape(out):
    """How to remake ``out`` (a fresh meta tensor, or a tuple / list of
    them) as new meta tensors; None for any other result (a factory op
    with no tensor argument may make a tensor on another device)."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)) and all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            for t in out):
        return (type(out), tuple(_meta_shape(t) for t in out))
    return None


def _remake(shape):
    if isinstance(shape[0], type):
        return shape[0](_remake(s) for s in shape[1])
    size, stride, dtype = shape
    return torch.empty_strided(size, stride, dtype=dtype, device="meta")


def _run(func, args, kwargs, key):
    """``func`` on its arguments.  On meta, an op whose outputs are fresh
    tensors and whose arguments (``key``) it has met before gets new empty
    tensors of the shapes it gave then: a meta kernel computes nothing but
    shapes, often in Python, and a decode or scan loop repeats the same op
    on the same shapes thousands of times."""
    if key is None:
        return func(*args, **kwargs)
    shape = _META_OUT.get(key)
    if shape is not None:
        return _remake(shape)
    out = func(*args, **kwargs)
    shape = _meta_shape(out)
    if shape is not None:
        _META_OUT[key] = shape
    return out


class Census(TorchDispatchMode):
    """Each aten op's flops and bytes moved, and the live and peak bytes of
    the storages the program makes.

    Flops are ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    registry: the matmuls, convolutions and attention ops), applied to each
    op here rather than through a second dispatch mode.  A storage is known
    by ``untyped_storage()._cdata`` (a meta tensor's ``data_ptr()`` is 0)
    and counted once, when an op first returns it; ``weakref.finalize`` on
    the storage takes it off when the storage itself dies, which is when
    its last tensor dies (the autograd graph's saved tensors included).
    ``exclude`` holds the storages of the arguments, which are counted
    apart."""

    def __init__(self, exclude=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = {}
        self._exclude = set(exclude)

    def _free(self, key: int, size: int) -> None:
        if self._known.pop(key, None) is not None:
            self.live -= size

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._exclude or key in self._known:
            return
        size = st.nbytes()
        self._known[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, size)

    @staticmethod
    def _traffic(args, kwargs, ins, outs, written) -> int:
        if not written:
            return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        targets = [args[i] if i < len(args) else kwargs.get(n)
                   for i, n in written]
        others = [_nbytes(a) for a in ins
                  if not any(a is t for t in targets)]
        target = sum(_nbytes(t) for t in targets if t is not None)
        # an in-place write reads its other operands and writes as many
        # bytes into the target; with no other operand it reads and
        # writes the target
        return sum(others) + 2 * (min(target, max(others)) if any(others)
                                  else target)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        moves, written, flop_fn, fresh = _op_info(func)
        ins, unknown = [], []
        key = (func, _walk_args(args, ins, unknown),
               _walk_args(tuple(sorted(kwargs.items())), ins, unknown))
        out = _run(func, args, kwargs, key if fresh and not unknown
                   else None)
        outs = list(_tensors(out))
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        if moves:
            self.bytes += self._traffic(args, kwargs, ins, outs, written)
        for t in outs:
            self._track(t)
        return out

def _storages(tree) -> set:
    keys = set()
    shard_lib._walk(tree, lambda p, t: keys.add(t.untyped_storage()._cdata))
    return keys


@dataclass
class Count:
    """What one run of a cell's program counted."""

    flops: int
    bytes: int
    temp_peak: int
    kernel_calls: dict
    seconds: float


def count(cell: Cell) -> Count:
    """Run ``cell`` once under the counters: aten's flops, the kernels'
    flops and bytes (``kernels.cost``), every op's bytes and the peak of
    the storages made."""
    census = Census(_storages(cell.args))
    t0 = time.perf_counter()
    with cost.counting() as kernels, census:
        out = cell.fn(*cell.args)
    del out
    return Count(census.flops + kernels.flops, census.bytes + kernels.bytes,
                 census.peak, dict(kernels.calls), time.perf_counter() - t0)


# a prefill of an arch with no attention layer costs the same at every
# position (the sLSTM steps, the mLSTM's 64-position chunks), so its
# flops and bytes are affine in the length, and so is its peak once one
# program point holds it (xlstm-1.3b: from 1,024 positions on; at 512 the
# peak still sits elsewhere): traced at these lengths, they give the full
# length's when their differences agree exactly.  Tracing the sLSTM's
# 32,768 steps a layer one by one would take the better part of an hour.
AFFINE_LENGTHS = (1024, 1536, 2048)


def affine_count(build_at: Callable, seq: int) -> Optional[Count]:
    """The count of a cell at ``seq`` positions from its counts at
    ``AFFINE_LENGTHS`` (``build_at(length)`` makes the cell), when flops,
    bytes and the temporary peak are affine in the length there and the
    kernel calls do not change; else None."""
    lo, mid, hi = AFFINE_LENGTHS
    step = mid - lo
    if hi - mid != step or seq < lo or (seq - lo) % step:
        return None
    cs = [count(build_at(n)) for n in AFFINE_LENGTHS]
    if not cs[0].kernel_calls == cs[1].kernel_calls == cs[2].kernel_calls:
        return None
    out = []
    for field in ("flops", "bytes", "temp_peak"):
        a, b, c = (getattr(x, field) for x in cs)
        if b - a != c - b:
            return None
        out.append(a + (b - a) * ((seq - lo) // step))
    return Count(*out, dict(cs[0].kernel_calls),
                 sum(x.seconds for x in cs))


def argument_bytes(cell: Cell) -> int:
    """What one device holds of the cell's arguments."""
    return sum(shard_lib.per_device_bytes(a, s, cell.mesh)
               for a, s in zip(cell.args, cell.specs))


def roofline_terms(rec: dict, dtype: str = "bfloat16") -> dict:
    """Compute and memory terms (seconds) at one H100's peak rates."""
    terms = {"compute_s": rec["flops_per_device"] / cost.PEAK_FLOPS[dtype],
             "memory_s": rec["bytes_per_device"] / cost.HBM_BYTES_PER_S}
    dom = max(terms, key=terms.get)
    total = terms[dom]
    terms["dominant"] = dom
    terms["bound_step_s"] = total
    terms["compute_fraction_of_bound"] = (terms["compute_s"] / total
                                          if total > 0 else 0.0)
    return terms


def measure(cell: Cell, c: Optional[Count] = None) -> dict:
    """The record fields of a cell, from one counted run on meta (``c``
    when the same program was counted already)."""
    n_dev = cell.mesh.num_devices
    c = count(cell) if c is None else c
    args = argument_bytes(cell)
    temp = c.temp_peak // n_dev
    rec = dict(
        n_devices=n_dev, trace_s=c.seconds,
        split="even split: global count / n_devices",
        flops=c.flops, bytes=c.bytes,
        flops_per_device=c.flops / n_dev,
        bytes_per_device=c.bytes / n_dev,
        memory={"argument_bytes": args, "temp_bytes": temp,
                "peak_per_device": args + temp,
                "fits_h100_80gb": args + temp <= cost.HBM_BYTES},
        collectives=None,
        pod_boundary_bytes=float(cell.handoff_bytes),
        tokens_per_step=cell.tokens_per_step, kv_dtype=cell.kv_dtype,
        kernel_calls=c.kernel_calls, dtype=cell.dtype)
    rec["roofline"] = roofline_terms(rec, cell.dtype)
    return rec


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: Optional[str] = None, variant: str = "",
             counted: Optional[dict] = None) -> dict:
    """One cell's record, written to ``out_dir``.  ``counted`` (a dict)
    keeps each training program's count across meshes: the pod axis folds
    into data parallelism, so a training cell runs the same program on
    one pod and on two, and is traced once."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "ok": False, "skipped": False}
    cfg = get_arch(arch)
    if shape_name == "long_500k" and not cfg.is_subquadratic():
        rec.update(skipped=True, ok=True,
                   reason="pure full-attention arch: 500k KV decode is "
                          "intentionally out of scope (see DESIGN.md)")
        _write(rec, out_dir)
        return rec
    try:
        cell = build_cell(arch, shape_name, mesh_name, variant)
        shape = SHAPES[shape_name]
        key = (arch, shape_name, variant)
        reuse = counted is not None and shape.kind == "train"
        c = counted.get(key) if reuse else None
        if c is None and shape.kind == "prefill" and \
                cfg.attention_layer_count() == 0:
            c = affine_count(lambda n: build_cell(
                arch, shape_name, mesh_name, variant, n), shape.seq_len)
            rec["counted_at"] = list(AFFINE_LENGTHS) if c else None
        if reuse and c is None:
            c = counted[key] = count(cell)
        rec.update(measure(cell, c), ok=True)
    except Exception as e:  # noqa: BLE001 — every failure is a bug report
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: Optional[str]) -> None:
    d = out_dir or OUT_DIR
    os.makedirs(d, exist_ok=True)
    v = f"__{rec['variant']}" if rec.get("variant") else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{v}.json"
    with open(os.path.join(d, name), "w") as f:
        json.dump(rec, f, indent=1)


def _run_task(arch: str, shape: str, meshes: tuple, out_dir, variant: str,
              skip_existing: bool) -> list:
    """The records of arch x shape on ``meshes``, in order; a training
    program is traced once for both meshes."""
    recs, counted = [], {}
    for mesh in meshes:
        v = f"__{variant}" if variant else ""
        path = os.path.join(out_dir or OUT_DIR,
                            f"{arch}__{shape}__{mesh}{v}.json")
        if skip_existing and os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            if rec.get("ok"):
                recs.append(rec)
                continue
        recs.append(run_cell(arch, shape, mesh, out_dir, variant, counted))
    return recs


def run_all(out_dir: Optional[str] = None, variant: str = "",
            skip_existing: bool = False, jobs: int = 1, log=print) -> list:
    """Every cell (arch x shape x mesh), each record written as it is made;
    with ``jobs`` > 1 they run in that many worker processes, the training
    cells (the longest traces) first."""
    archs = [a for a in list_archs() if a != "llama3-70b"] + ["llama3-70b"]
    both = ("single_pod", "multi_pod")
    tasks = [(a, s, both) for a in archs for s in SHAPES
             if SHAPES[s].kind == "train"]
    tasks += [(a, s, (m,)) for m in both for a in archs for s in SHAPES
              if SHAPES[s].kind != "train"]
    args = [t + (out_dir, variant, skip_existing) for t in tasks]
    if jobs > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(jobs) as pool:
            results = pool.starmap(_run_task, args, chunksize=1)
    else:
        results = [_run_task(*a) for a in args]
    recs = [r for pair in results for r in pair]
    for rec in recs:
        status = ("skip" if rec["skipped"] else "ok") if rec["ok"] \
            else "FAIL"
        log(f"[{status}] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
            f"({rec.get('trace_s', 0.0):.1f}s)")
    return recs


# ---------------------------------------------------------------------------
# The card check: predicted on meta, then run for real
# ---------------------------------------------------------------------------


def _allocated(device) -> tuple:
    """(allocated, requested) bytes on the card, after a synchronise."""
    torch.cuda.synchronize(device)
    stats = torch.cuda.memory_stats(device)
    return (stats["allocated_bytes.all.current"],
            stats["requested_bytes.all.current"])


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator on expandable segments inside the block.  On
    fixed segments it hands a tensor a whole free block whenever splitting
    would leave 1 MiB or less (its ``should_split`` rule), so
    ``memory_allocated`` grows by up to 1 MiB more than a tensor's bytes
    (0.68% over gemma3-1b's float32 weights and moments); an expandable
    segment is split to the 512-byte rounding."""
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch._C._accelerator_setAllocatorSettings(
            "expandable_segments:False")


def check_cell(build: Callable, device="cuda", params=None) -> dict:
    """Predict a one-card cell on meta, then build it on ``device`` and run
    it once under the same counters, then once more uncounted and timed
    (host clock, synchronised); on expandable segments
    (``_expandable_segments``).  ``build(device, params)`` makes the cell;
    ``params``, when given, are weights already on the card (their bytes
    are then taken from their storages, not from an allocation).  Returns
    the prediction, what the card counted and allocated (and what its
    tensors asked the allocator for), the step's seconds, and the cell's
    weights (``"params"``)."""
    device = resolve_device(device)
    pred = measure(build("meta", None))
    with _expandable_segments():
        base = _allocated(device)
        real = build(device, params)
        grown = [x - y for x, y in zip(_allocated(device), base)]
        if params is not None:
            held = sum(shard_lib.leaf_bytes(t) for t in leaves(params))
            grown = [g + held for g in grown]
        torch.cuda.reset_peak_memory_stats(device)
        before = _allocated(device)[0]
        c = count(real)
        peak = torch.cuda.max_memory_allocated(device) - before
        t0 = time.perf_counter()
        out = real.fn(*real.args)
        torch.cuda.synchronize(device)
        step_s = time.perf_counter() - t0
        del out
        got = {"predicted": pred, "argument_bytes": grown[0],
               "argument_requested": grown[1], "flops": c.flops,
               "bytes": c.bytes, "kernel_calls": c.kernel_calls,
               "temp_peak": peak, "traced_temp_peak": c.temp_peak,
               "step_s": step_s, "params": real.args[0]}
        del real
    return got


def check_summary(name: str, got: dict) -> dict:
    """The comparisons ``--check`` gates, for one checked cell."""
    pred = got["predicted"]
    p_args = pred["memory"]["argument_bytes"]
    p_temp = pred["memory"]["temp_bytes"]
    bound = pred["roofline"]["bound_step_s"]
    return {
        "cell": name,
        "argument_bytes": [p_args, got["argument_bytes"]],
        "argument_requested": got["argument_requested"],
        "argument_rel_err": abs(p_args - got["argument_bytes"])
        / max(got["argument_bytes"], 1),
        "flops": [pred["flops"], got["flops"]],
        "flops_equal": pred["flops"] == got["flops"],
        "peak": [p_args + p_temp, got["argument_bytes"] + got["temp_peak"]],
        "peak_ratio": (p_args + p_temp)
        / max(got["argument_bytes"] + got["temp_peak"], 1),
        # the census's own peak over the card's run, beside the allocator's
        "card_traced_temp": got["traced_temp_peak"],
        "step_ms": got["step_s"] * 1e3, "bound_ms": bound * 1e3,
        "step_over_bound": got["step_s"] / bound if bound else float("inf"),
        "dominant": pred["roofline"]["dominant"],
        "kernel_calls": got["kernel_calls"],
    }


CHECK_ARG_TOL = 0.005
CHECK_PEAK_BAND = (0.8, 1.25)


def gate(summary: dict) -> list:
    """The failed gates of a check summary (empty when it passes)."""
    bad = []
    if summary["argument_rel_err"] > CHECK_ARG_TOL:
        bad.append(f"argument bytes off by {summary['argument_rel_err']:.2%}")
    if not summary["flops_equal"]:
        bad.append(f"flops {summary['flops']} differ")
    lo, hi = CHECK_PEAK_BAND
    if not lo <= summary["peak_ratio"] <= hi:
        bad.append(f"peak ratio {summary['peak_ratio']:.3f} outside "
                   f"[{lo}, {hi}]")
    if summary["step_over_bound"] < 1.0:
        bad.append(f"step {summary['step_ms']:.2f} ms beats the bound "
                   f"{summary['bound_ms']:.2f} ms")
    return bad


# the one-card cells, full width: (name, builder(device, params)); the two
# yi-9b cells share weights
def _yi_prefill(device, params):
    cfg = get_arch("yi-9b")
    return prefill_cell(cfg, runtime_for("prefill"), 2, 8192, ONE_CARD,
                        device=device, params=params)


def _yi_pipe(device, params):
    cfg = get_arch("yi-9b")
    pcfg = pipe_lib.PipelineConfig(n_stages=2, n_microbatches=4, mb_size=4)
    return pipe_cell(cfg, runtime_for("decode"), pcfg, 512, 576, ONE_CARD,
                     prefill=True, decode_steps=1, device=device,
                     params=params)


def _gemma_train(device, params):
    cfg = get_arch("gemma3-1b")
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    return train_cell(cfg, rt, opt_lib.AdamWConfig(), 4, 1024, ONE_CARD,
                      device=device, params=params)


CHECKS = (("dryrun-prefill", _yi_prefill), ("dryrun-pipe", _yi_pipe),
          ("dryrun-train", _gemma_train))


def run_checks(device="cuda", log=print) -> list:
    """Every one-card cell of ``CHECKS``, predicted then run; the yi-9b
    weights the first cell makes serve the second."""
    out, params = [], None
    for name, build in CHECKS:
        got = check_cell(build, device, params if build is _yi_pipe else None)
        made = got.pop("params")
        params = made if build is _yi_prefill else None
        summary = check_summary(name, got)
        log(json.dumps(summary))
        out.append(summary)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for --all")
    ap.add_argument("--variant", default="", choices=sorted(VARIANTS))
    ap.add_argument("--check", action="store_true",
                    help="run the one-card cells on the card against their "
                         "prediction")
    ap.add_argument("--device", default=None,
                    help="the card for --check (cuda unless asked)")
    args = ap.parse_args(argv)

    if args.check:
        bad = []
        for s in run_checks(args.device):
            bad += [f"{s['cell']}: {b}" for b in gate(s)]
        for b in bad:
            print(f"FAIL {b}")
        return 1 if bad else 0
    if args.all:
        recs = run_all(args.out, args.variant, args.skip_existing,
                       args.jobs)
        fails = [(r["arch"], r["shape"], r["mesh"]) for r in recs
                 if not r["ok"]]
        if fails:
            print(f"{len(fails)} failures: {fails}")
        return 1 if fails else 0
    if not args.arch or not args.shape:
        ap.error("--arch and --shape, or --all, or --check")
    mesh_name = "multi_pod" if args.mesh == "multi" else "single_pod"
    rec = run_cell(args.arch, args.shape, mesh_name, args.out, args.variant)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
