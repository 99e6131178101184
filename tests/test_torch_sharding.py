"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, at the published widths of every arch.

Both sides are shapes only: ``jax.eval_shape`` of the JAX package's
``init_params`` / caches, and the port's meta-device trees (nothing is
allocated).  The JAX trees stack each pattern position's layers on a
leading dim (``"scan"``, and the pipeline's ``"stage"`` / ``"epi_scan"``)
and keep the remainder under ``"tail"``; the port holds one dict a layer.
So a JAX spec is held against the port's spec of every layer it stands
for, with its stacking entries dropped (the pipeline's ``"pod"`` entry
kept), as ``models.convert`` maps the weights; and the bytes a device
holds, from JAX's specs over JAX's shapes, against
``per_device_bytes`` over the port's.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.core import pipeline as jpipe
from repro.distributed import sharding as jshard
from repro.models import model as jmodel
from repro.models.common import Runtime as JRuntime
from repro.serving import kv_cache as jkv
from repro_torch import config as tconfig
from repro_torch.core import pipeline as tpipe
from repro_torch.distributed import sharding as tshard
from repro_torch.models import model as tmodel
from repro_torch.models.common import Runtime, make_layer_plan
from repro_torch.serving import kv_cache as tkv
from repro_torch.training import optimizer as topt

ARCHS = tconfig.list_archs()
SINGLE = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}


class FakeMesh:
    """What ``repro.distributed.sharding`` reads of a mesh."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _rt(kv="bf16"):
    return (JRuntime(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                     kv_dtype=kv), Runtime(kv_dtype=kv))


@lru_cache(maxsize=None)
def _params(arch):
    jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
    jrt, trt = _rt()
    jp = jax.eval_shape(lambda: jmodel.init_params(
        jcfg, jax.random.PRNGKey(0), jrt))
    return jcfg, tcfg, jp, tmodel.init_params(tcfg, 0, trt, "meta")


def _spec(p) -> tuple:
    return tuple(p)


def _jax_bytes(tree, specs, ms) -> int:
    """Bytes a device holds, from JAX's specs over JAX's shapes."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree),
                          jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        div = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    div *= ms[ax]
        assert n % div == 0
        total += n // div
    return total


def _flat(tree, prefix=()):
    """(path, leaf) of a nested dict, dict keys only."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _layer_index(cfg, section: str, pos: int, i: int = 0) -> int:
    """The port's layer index of JAX's ``section[pos]``, stacked element
    ``i`` (a period), in the flat order period by period, then the tail."""
    plan = make_layer_plan(cfg.num_layers, cfg.block_pattern)
    period = len(plan.period_kinds)
    if section == "tail":
        return plan.n_periods * period + pos
    return i * period + pos


def _assert_layers_match(cfg, jtree, tlayers, n_lead: int):
    """Every stacked (``"scan"``, ``n_lead`` stacking dims) and tail JAX
    spec equals the port's spec of each layer it stands for."""
    plan = make_layer_plan(cfg.num_layers, cfg.block_pattern)
    for section in ("scan", "tail"):
        lead, periods = (0, range(1)) if section == "tail" else \
            (n_lead, range(plan.n_periods))
        for pos, layer in enumerate(jtree.get(section) or []):
            for path, spec in _flat(layer):
                want = _spec(spec)[lead:]
                for i in periods:
                    li = _layer_index(cfg, section, pos, i)
                    got = _get(tlayers[li], path)
                    assert got == want, (section, pos, path, li, got, want)


# ---------------------------------------------------------------------------
# parameters and optimizer state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_bytes_match_jax(arch):
    jcfg, tcfg, jp, tp = _params(arch)
    for ms in (SINGLE, POD):
        for fsdp in (False, True):
            js = jshard.param_specs(jp, jcfg, FakeMesh(ms), fsdp=fsdp)
            ts = tshard.param_specs(tp, tcfg, ms, fsdp=fsdp)
            for k in js["embed"]:
                assert ts["embed"][k] == _spec(js["embed"][k])
            assert ts["final_norm"] == _spec(js["final_norm"])
            _assert_layers_match(tcfg, js, ts["layers"], 1)
            assert tshard.per_device_bytes(tp, ts, ms) == \
                _jax_bytes(jp, js, ms)
            # the moments take the parameters' specs, the step none
            jo = jshard.opt_state_specs(js)
            to = tshard.opt_state_specs(ts)
            assert to.step == _spec(jo.step) == ()
            assert to.m == ts and to.v == ts


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_param_specs_match_jax(arch):
    """``pipeline=True``: JAX's stage-stacked weights (n_stages, pps, ...)
    over "pod" against the port's staged layers, each with the leading
    "pod" entry; the bytes a device holds of the stages equal."""
    jcfg, tcfg, jp, tp = _params(arch)
    n_s = POD["pod"]
    try:
        tpipe.split_layers(tcfg, n_s)
    except ValueError:
        with pytest.raises(ValueError):
            jpipe.split_layers(jcfg, n_s)
        return
    stages, _ = jax.eval_shape(
        lambda p: jpipe.split_scan_params(p, jcfg, n_s), jp)
    js = jshard.param_specs(stages, jcfg, FakeMesh(POD), pipeline=True)
    ts = tshard.param_specs(tp, tcfg, POD, pipeline=True)
    pps, _ = tpipe.split_layers(tcfg, n_s)
    period = len(tcfg.block_pattern)
    n_staged = tshard.staged_layers(tcfg, n_s)
    assert n_staged == n_s * pps * period
    for pos, layer in enumerate(js):
        for path, spec in _flat(layer):
            want = ("pod",) + _spec(spec)[2:]
            for li in range(pos, n_staged, period):
                assert _get(ts["layers"][li], path) == want
    # the layers after the stages (the epilogue) and the embeddings stay
    # as without a pipeline
    plain = tshard.param_specs(tp, tcfg, POD)
    assert ts["layers"][n_staged:] == plain["layers"][n_staged:]
    assert ts["embed"] == plain["embed"]
    staged = {"layers": tp["layers"][:n_staged]}
    assert tshard.per_device_bytes(
        staged, {"layers": ts["layers"][:n_staged]}, POD) == \
        _jax_bytes(stages, js, POD)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_bytes_match_jax(arch):
    """Dense caches (bf16 and int8, a batch over "data" and one row whose
    sequence goes over "data" too) and the serving engine's paged caches
    (JAX keeps a page table a layer, the port one for all)."""
    jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
    for kv in ("bf16", "int8"):
        jrt, trt = _rt(kv)
        for batch, cap in ((128, 1024), (1, 4096)):
            jc = jax.eval_shape(lambda: jmodel.init_caches(jcfg, batch, cap,
                                                           jrt))
            tc = tmodel.init_caches(tcfg, batch, cap, trt, "meta")
            for ms in (SINGLE, POD):
                js = jshard.cache_specs(jc, jcfg, FakeMesh(ms))
                ts = tshard.cache_specs(tc, tcfg, ms)
                _assert_layers_match(tcfg, js, ts["layers"], 1)
                assert tshard.per_device_bytes(tc, ts, ms) == \
                    _jax_bytes(jc, js, ms)
    jrt, trt = _rt()
    jpool = jkv.PoolConfig(page_size=16, n_local_pages=256,
                           n_global_pages=64, max_pages_per_seq=32)
    tpool = tkv.PoolConfig(page_size=16, n_local_pages=256,
                           n_global_pages=64, max_pages_per_seq=32)
    jc = jax.eval_shape(lambda: jkv.build_paged_caches(jcfg, 16, jpool, jrt))
    tc = tkv.build_paged_caches(tcfg, 16, tpool, trt, "meta")
    for ms in (SINGLE, POD):
        js = jshard.cache_specs(jc, jcfg, FakeMesh(ms))
        ts = tshard.cache_specs(tc, tcfg, ms)
        tables = []
        for section in ("scan", "tail"):
            for layer in js[section]:
                if "page_table" in layer:
                    n = 1 if section == "tail" else 0
                    tables.append(_spec(layer.pop("page_table"))[1 - n:])
        _assert_layers_match(tcfg, js, ts["layers"], 1)
        assert all(t == ts["page_table"] for t in tables)
        no_tables = {k: [{n: v for n, v in layer.items()
                          if n != "page_table"} for layer in jc[k]]
                     for k in ("scan", "tail")}
        assert tshard.per_device_bytes(tc["layers"], ts["layers"], ms) == \
            _jax_bytes(no_tables, {"scan": js["scan"], "tail": js["tail"]},
                       ms)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_cache_specs_and_bytes_match_jax(arch):
    """The fixed-batch passes' caches: stage caches (sequence split,
    ``seq_kv``, the "pod" entry) a microbatch, the epilogue's over the
    global batch."""
    jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
    jrt, trt = _rt()
    try:
        pps, leftover = tpipe.split_layers(tcfg, 2)
    except ValueError:
        return
    period = len(tcfg.block_pattern)
    for n_mb, mb, cap in ((4, 32, 1024), (1, 1, 2048)):
        jp = jpipe.PipelineConfig(n_stages=2, n_microbatches=n_mb,
                                  mb_size=mb)
        tp = tpipe.PipelineConfig(n_stages=2, n_microbatches=n_mb,
                                  mb_size=mb)
        jc = jax.eval_shape(lambda: jpipe.init_pipeline_caches(jcfg, jp, cap,
                                                               jrt))
        tc = tpipe.init_pipeline_caches(tcfg, tp, cap, trt, "meta")
        js = jshard.cache_specs(jc, jcfg, FakeMesh(POD), pipeline=True)
        ts = tshard.cache_specs(tc, tcfg, POD)
        n_staged = 2 * pps * period
        for pos, layer in enumerate(js["stage"]):
            for path, spec in _flat(layer):
                want = ("pod",) + _spec(spec)[3:]
                for m in range(n_mb):
                    for li in range(pos, n_staged, period):
                        assert _get(ts["stage"][m]["layers"][li], path) == \
                            want
        for pos, layer in enumerate(js["epi_scan"]):
            for path, spec in _flat(layer):
                for e in range(leftover):
                    li = n_staged + e * period + pos
                    assert _get(ts["epilogue"]["layers"][li], path) == \
                        _spec(spec)[1:]
        plan = make_layer_plan(tcfg.num_layers, tcfg.block_pattern)
        for j, layer in enumerate(js["tail"]):
            li = plan.n_periods * period + j
            for path, spec in _flat(layer):
                assert _get(ts["epilogue"]["layers"][li], path) == \
                    _spec(spec)
        assert tshard.per_device_bytes(tc, ts, POD) == \
            _jax_bytes(jc, js, POD)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch):
    """Pod folding, a batch no mesh divides, every front end's inputs."""
    jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
    for batch in (256, 32, 3):
        B, S, D = batch, 64, tcfg.d_model
        shapes = {"tokens": ((B, S), jnp.int32, torch.int32),
                  "labels": ((B, S), jnp.int32, torch.int32),
                  "frames": ((B, S, D), jnp.bfloat16, torch.bfloat16),
                  "scalar": ((), jnp.float32, torch.float32)}
        jb = {k: jax.ShapeDtypeStruct(s, jd) for k, (s, jd, _) in
              shapes.items()}
        tb = {k: torch.empty(s, dtype=td, device="meta") for k, (s, _, td)
              in shapes.items()}
        for ms in (SINGLE, POD):
            for fold in (True, False):
                js = jshard.batch_specs(jb, FakeMesh(ms), fold_pod=fold)
                ts = tshard.batch_specs(tb, ms, fold_pod=fold)
                assert ts == {k: _spec(v) for k, v in js.items()}
                assert tshard.per_device_bytes(tb, ts, ms) == \
                    _jax_bytes(jb, js, ms)


def test_optimizer_state_bytes_follow_the_moments_dtype():
    """bf16 moments (the MoE giants' training cells) take half the bytes
    of float32 ones on the same specs, as in the JAX dry run."""
    _, tcfg, _, tp = _params("qwen3-moe-235b-a22b")
    ts = tshard.param_specs(tp, tcfg, SINGLE, fsdp=True)
    os_ = tshard.opt_state_specs(ts)
    half = topt.init(topt.AdamWConfig(moment_dtype=torch.bfloat16), tp)
    full = topt.init(topt.AdamWConfig(moment_dtype=torch.float32), tp)
    # the int32 step (4 bytes) is whole on every device
    assert 2 * (tshard.per_device_bytes(half, os_, SINGLE) - 4) == \
        tshard.per_device_bytes(full, os_, SINGLE) - 4
