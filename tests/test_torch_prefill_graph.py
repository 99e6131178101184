"""The captured prefill steps (``repro_torch.serving.step_graph``'s prefill
keys) of both backends, float32 on the CPU.

On the CPU a prefill step runs eagerly through the same static inputs and
outputs that its captured graph reads and writes on the card (the routing
rule), so these tests hold that path against the eager step it replaced,
bit for bit: the local backend's chunk (``_chunk_fn``), the pipe's stages
and drain (``core.pipeline.pipeline_prefill_chunk_tick``) and the exact
prefill into a slot named by a device tensor (``_prefill_fn``), and the
exact prefill against ``repro``'s ``_prefill_fn`` on the same weights.
``CPUGraphs`` (``tests/test_torch_step_graph.py``) stands in for the
card's graphs: its capture runs the step once and its replay runs it
again, so the deferred capture of the exact-prefill keys, the state
restore, the launch books and the strict auditor's pins are exercised
here too.  On the card ``chip_smoke.py`` holds real replays against the
eager steps (``[graph-parity]``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import backend as jax_backend  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch.analysis.invariants import InvariantViolation  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.kernels import chunk_attention as CA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.backend import (LocalBackend,  # noqa: E402
                                         PipelinedBackend, PrefillChunk)
from repro_torch.serving.request import SamplingParams  # noqa: E402
from test_torch_step_graph import (JRT, TRT, CPU, CPUGraphs,  # noqa: E402
                                   _assert_caches_equal, _clone, _filled,
                                   _params)

# logits and caches against repro's _prefill_fn (tests/test_torch_model.py)
TOL = 1e-4
# the two exact-prefill models: (local, global) and (rglru, rglru, local),
# two periods each, so that a 2-stage pipe holds a period a stage
EXACT = {"local-global": ("gemma3-12b", ("local", "global"), 4),
         "rglru-rglru-local": ("recurrentgemma-9b",
                               ("rglru", "rglru", "local"), 6)}


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(backend_mod, "StepGraphs", CPUGraphs)


def _use(graphs, monkeypatch):
    if graphs == "stand-in":
        monkeypatch.setattr(backend_mod, "StepGraphs", CPUGraphs)


def _exact_params(name):
    arch, pattern, layers = EXACT[name]
    kw = dict(block_pattern=pattern, num_layers=layers)
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw)
    tcfg = dataclasses.replace(reduced_config(get_arch(arch)), **kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(3), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _chunk(rng, tcfg, table, slots, offsets, n_valid, clen):
    """A prefill chunk over ``slots`` (-1: a pad row) with their table
    rows; a row's last index is set where its valid tokens end a chunk
    shorter than ``clen``."""
    rows = len(slots)
    n_valid = np.asarray(n_valid, np.int32)
    lasts = np.where(n_valid < clen, n_valid - 1, -1).astype(np.int32)
    lasts[n_valid == 0] = -1
    tables = np.stack([table[s] if s >= 0 else np.zeros_like(table[0])
                       for s in slots]).astype(np.int32)
    return PrefillChunk(
        tokens=rng.randint(1, tcfg.vocab_size, (rows, clen)).astype(
            np.int32),
        offsets=np.asarray(offsets, np.int32), n_valid=n_valid, lasts=lasts,
        tables=tables, seqs=[None] * rows)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ local chunk

@pytest.mark.parametrize("graphs", ["eager", "stand-in"])
def test_local_chunk_step_equals_the_eager_chunk(graphs, monkeypatch):
    """Two chunks with different rows and offsets (a pad row in the
    second): the static-buffer chunk step gives ``_chunk_fn``'s logits and
    pools bit for bit; one key serves both, captured once; the first
    result's logits are a copy the second replay leaves alone."""
    _use(graphs, monkeypatch)
    _, tcfg, _, tparams = _params("yi-9b")
    pool, caches = _filled(tcfg, 4, 5)
    table = caches["page_table"].numpy().copy()
    be = LocalBackend(tcfg, tparams, TRT, mb_size=2, num_microbatches=2,
                      pool=pool, device=CPU, caches=caches)
    ref = _clone(caches)
    rng = np.random.RandomState(0)
    chunks = [_chunk(rng, tcfg, table, [0, 2, 3], [0, 8, 16], [8, 5, 8], 8),
              _chunk(rng, tcfg, table, [1, 0, -1], [16, 8, 0], [3, 8, 0], 8)]
    kept = []
    for chunk in chunks:
        (res,) = be.prefill_step(chunk)
        want = LocalBackend._chunk_fn(
            tparams, ref, _t(chunk.tokens), _t(chunk.offsets),
            _t(chunk.n_valid), _t(chunk.lasts), _t(chunk.tables), cfg=tcfg,
            rt=TRT)
        assert res.chunk is chunk and res.logits.shape == (3, tcfg.vocab_size)
        assert torch.equal(res.logits, want)
        _assert_caches_equal(be.caches, ref)
        kept.append((res.logits, want))
    first, want = kept[0]
    assert torch.equal(first, want)             # the later replay kept off
    assert be.prefill_chunks == 2
    if graphs == "stand-in":
        st = be.graphs.stats()
        assert st["keys"] == st["captures"] == 1
        assert list(be.graph_entries()) == [("chunk", 3, 8, 4)]
        assert st["replays_by_kind"] == {"chunk": 2}
        assert st["prefill_replays"] == 2 and st["decode_replays"] == 0


def test_local_chunk_replays_book_the_chunk_kernel_a_layer(monkeypatch,
                                                           stand_in):
    """With the plain chunk attention standing in for counted launches of
    the kernel (the card's route), three chunks of one key: each replay
    gives ``_chunk_fn``'s logits and pools bit for bit and books one
    launch a model layer, as the card's 48 a yi-9b chunk call; the
    capture's warm-up launches are booked apart and put back."""
    orig = kops.ref.paged_chunk_attention_ref

    def counted(*a, **k):
        CA.paged_chunk_attention.launches += 1
        return orig(*a, **k)
    monkeypatch.setattr(kops.ref, "paged_chunk_attention_ref", counted)
    _, tcfg, _, tparams = _params("yi-9b")
    layers = tcfg.num_layers
    pool, caches = _filled(tcfg, 4, 5)
    table = caches["page_table"].numpy().copy()
    be = LocalBackend(tcfg, tparams, TRT, mb_size=2, num_microbatches=2,
                      pool=pool, device=CPU, caches=caches)
    ref = _clone(caches)
    rng = np.random.RandomState(5)
    chunks = [_chunk(rng, tcfg, table, [0, 2, 3], [0, 8, 16], [8, 5, 8], 8),
              _chunk(rng, tcfg, table, [1, 0, -1], [16, 8, 0], [3, 8, 0], 8),
              _chunk(rng, tcfg, table, [3, 1, 2], [8, 0, 16], [8, 8, 2], 8)]
    for i, chunk in enumerate(chunks):
        before = CA.paged_chunk_attention.launches
        (res,) = be.prefill_step(chunk)
        assert CA.paged_chunk_attention.launches - before == layers
        want = LocalBackend._chunk_fn(
            tparams, ref, _t(chunk.tokens), _t(chunk.offsets),
            _t(chunk.n_valid), _t(chunk.lasts), _t(chunk.tables), cfg=tcfg,
            rt=TRT)
        assert torch.equal(res.logits, want)
        _assert_caches_equal(be.caches, ref)
    st = be.graphs.stats()
    assert st["captures"] == 1 and st["replays"] == len(chunks)
    assert be.graphs.warmup_launches == {"chunk_attention": layers}
    assert layers == sum(k in ("attn", "global") for k in tcfg.layer_kinds())


# ------------------------------------------------------------ the pipe

@pytest.mark.parametrize("graphs", ["eager", "stand-in"])
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_pipe_prefill_steps_equal_the_eager_tick(wire, graphs, monkeypatch):
    """Two stages, three chunks then drain ticks: the static-buffer stage
    and drain steps give ``pipeline_prefill_chunk_tick``'s logits and
    pools bit for bit on both wires; a drained result's logits outlive
    the ticks after it."""
    _use(graphs, monkeypatch)
    _, tcfg, _, tparams = _params("yi-9b")
    pool, caches = _filled(tcfg, 6, 6)
    table = caches["page_table"].numpy().copy()
    be = PipelinedBackend(tcfg, tparams, TRT, mb_size=2, num_microbatches=3,
                          pool=pool, device=CPU, n_stages=2, wire_dtype=wire,
                          caches=caches)
    ref = _clone(caches)
    rng = np.random.RandomState(2)
    plan = [_chunk(rng, tcfg, table, [0, 4], [0, 16], [8, 6], 8),
            _chunk(rng, tcfg, table, [1, 5], [8, 0], [8, 2], 8),
            _chunk(rng, tcfg, table, [3, -1], [24, 0], [4, 0], 8),
            None, None]
    entries, act = [None, None], [None, None]
    got, want = [], []
    for chunk in plan:
        got += be.prefill_step(chunk)
        entries = [chunk] + entries[:-1]
        if not any(e is not None for e in entries):
            continue
        zero = np.zeros((2,), np.int32)
        stage = lambda name: _t(np.stack(
            [getattr(e, name) if e is not None else
             (zero if name != "tables" else np.zeros((2, 4), np.int32))
             for e in entries]))
        drained = entries[-1]
        logits, act = PL.pipeline_prefill_chunk_tick(
            tparams, ref, act,
            _t(entries[0].tokens if entries[0] is not None
               else np.zeros((2, 8), np.int32)),
            stage("offsets"), stage("n_valid"), stage("tables"),
            _t(drained.lasts if drained is not None else zero),
            occupied=[e is not None for e in entries], cfg=tcfg, rt=TRT,
            n_stages=2, wire_dtype=wire)
        if drained is not None:
            want.append((drained, logits))
        _assert_caches_equal(be.caches, ref)
    assert len(got) == len(want) == 3
    for res, (chunk, logits) in zip(got, want):
        assert res.chunk is chunk and not res.lost
        assert torch.equal(res.logits, logits)
    assert be.prefill_stage_runs == 6 and be.prefill_drains == 3
    if graphs == "stand-in":
        st = be.graphs.stats()
        assert st["captures"] == st["keys"] == 3
        assert st["replays_by_kind"] == {"pf-stage": 6, "pf-drain": 3}
        assert sorted(be.graph_entries()) == [
            ("pf-drain", 2, 8, 4), ("pf-stage", 0, 2, 8, 4),
            ("pf-stage", 1, 2, 8, 4)]


# ------------------------------------------------------------ exact prefill

def _exact_setup(name, backend, seed=4):
    """An engine-format cache over 4 slots of 8 pages of 8 tokens, every
    row's rings and recurrent states random, and its backend."""
    jcfg, tcfg, jparams, tparams = _exact_params(name)
    pool = tkv.PoolConfig(page_size=8, n_local_pages=4 * 8 + 1,
                          max_pages_per_seq=8)
    kw = dict(mb_size=2, num_microbatches=2, pool=pool, device=CPU)
    be = LocalBackend(tcfg, tparams, TRT, **kw) if backend == "local" else \
        PipelinedBackend(tcfg, tparams, TRT, n_stages=2, **kw)
    table = 1 + np.arange(4 * 8, dtype=np.int32).reshape(4, 8)
    be.set_page_table(table)
    gen = torch.Generator().manual_seed(seed)
    for layer in be.caches["layers"]:
        for name_, t in layer.items():
            if name_ == "pos":
                t.copy_(torch.randint(0, 40, t.shape, generator=gen))
            elif name_ not in ("k_pages", "v_pages"):
                t.copy_(torch.randn(t.shape, generator=gen))
    return jcfg, tcfg, jparams, tparams, pool, table, be


def _prompts(tcfg, rng):
    """Two prompts of one bucket, both past the 32-token window: 37 and 34
    tokens, padded to 40 (a multiple of 8) or 64 (a power of two, with
    recurrent layers), as ``OfflineEngine._prefill_len`` pads them."""
    out = []
    for n in (37, 34):
        L = max(8, 1 << (n - 1).bit_length()) \
            if tcfg.recurrent_layer_count() else max(8, (n + 7) // 8 * 8)
        toks = np.zeros((L,), np.int32)
        toks[:n] = rng.randint(1, tcfg.vocab_size, n)
        out.append((toks, n - 1))
    return out


def _jax_layers(jc, cfg):
    """The JAX engine caches as the port's per-layer list (scan leaves
    stacked over periods, period by period, then the tail)."""
    period = len(cfg.block_pattern)
    layers = [{k: np.asarray(a[p]) for k, a in jc["scan"][i].items()}
              for p in range(cfg.num_layers // period)
              for i in range(period)]
    return layers + [{k: np.asarray(a) for k, a in c.items()}
                     for c in jc["tail"]]


@pytest.mark.parametrize("backend", ["local", "pipelined"])
@pytest.mark.parametrize("name", list(EXACT))
def test_exact_prefill_step_equals_the_eager_prefill(name, backend,
                                                     stand_in):
    """Two prompts of one bucket into slots 1 and 3 through one key a
    stage: logits, rings (the ``pos`` clean-up included), recurrent
    states and pools equal ``_prefill_fn``'s bit for bit, and the other
    slots' rows are untouched.  The bucket's first call runs eagerly, its
    second captures and replays."""
    _, tcfg, _, tparams, _, _, be = _exact_setup(name, backend)
    ref = _clone(be.caches)
    rng = np.random.RandomState(7)
    for slot, (toks, last) in zip((1, 3), _prompts(tcfg, rng)):
        before = _clone(be.caches)
        be.reset_slot(slot)
        tkv.reset_slot(ref, slot)
        got = be.prefill(toks, slot, last)
        want = LocalBackend._prefill_fn(
            tparams, ref, _t(toks[None]), slot, last, cfg=tcfg, rt=TRT,
            ranges=be.ranges, devices=be.stage_devices, head=be.head)
        assert got.shape == (tcfg.vocab_size,)
        assert torch.equal(got, want)
        _assert_caches_equal(be.caches, ref)
        for layer, old in zip(be.caches["layers"], before["layers"]):
            for leaf, t in layer.items():
                if leaf in ("k_pages", "v_pages"):
                    continue
                rows = [r for r in range(4) if r != slot]
                assert torch.equal(t[rows], old[leaf][rows]), leaf
        for layer in be.caches["layers"]:
            if "pos" in layer:              # cleaned past the last index
                assert int(layer["pos"][slot].max()) <= last
    L, n = len(toks), len(be.stage_devices)
    st = be.graphs.stats()
    assert sorted(be.graph_entries()) == [("exact", L, s) for s in range(n)]
    assert st["captures"] == st["keys"] == n
    assert st["eager_by_kind"] == {"exact": n}
    assert st["replays_by_kind"] == {"exact": n}
    assert be.exact_prefills == 2


@pytest.mark.parametrize("name", list(EXACT))
def test_exact_prefill_step_equals_repro(name, stand_in):
    """The same two prompts through ``repro.serving.backend``'s
    ``_prefill_fn`` on fresh JAX engine caches (the port's target rows
    reset to the same state): logits, the slots' recurrent states, their
    pages and their rings' live entries within ``TOL``, ring positions
    exactly (a ring slot whose position is -1 is never read, and keeps
    whatever the row held before)."""
    jcfg, tcfg, jparams, _, pool, table, be = _exact_setup(name, "local")
    jpool = jkv.PoolConfig(page_size=8, n_local_pages=4 * 8 + 1,
                           max_pages_per_seq=8)
    jc = jkv.set_page_table(jkv.build_paged_caches(jcfg, 4, jpool, JRT),
                            table)
    jfn = jax.jit(functools.partial(
        jax_backend._SlotCacheBackend._prefill_fn, cfg=jcfg, rt=JRT))
    rng = np.random.RandomState(7)
    for slot, (toks, last) in zip((1, 3), _prompts(tcfg, rng)):
        be.reset_slot(slot)
        got = be.prefill(toks, slot, last)
        jl, jc = jfn(jparams, jnp.asarray(toks)[None], jc, slot, last)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        pages = table[slot]
        for i, (g, w) in enumerate(zip(be.caches["layers"],
                                       _jax_layers(jc, jcfg))):
            for leaf, t in g.items():
                have = t.numpy()[pages] if leaf.endswith("_pages") \
                    else t.numpy()[slot]
                ref = w[leaf][pages] if leaf.endswith("_pages") \
                    else w[leaf][slot]
                if leaf == "pos":
                    np.testing.assert_array_equal(have, ref)
                elif "pos" in g:
                    live = w["pos"][slot] >= 0
                    np.testing.assert_allclose(have[live], ref[live],
                                               rtol=TOL, atol=TOL)
                else:
                    np.testing.assert_allclose(have, ref, rtol=TOL, atol=TOL,
                                               err_msg=f"layer {i} {leaf}")


def test_replays_add_the_captured_flash_and_scan_launches(monkeypatch,
                                                          stand_in):
    """With the plain kernels standing in for counted launches, three exact
    prefills of one bucket count three prefills' flash and scan launches:
    the eager first call as it runs, the capture put back, each replay
    adding what the capture launched; a deferred key warms nothing up."""
    for mod, fn_name, wrapper in ((kops.ref, "flash_attention_ref",
                                   FA.flash_attention),
                                  (kops.ref, "rglru_scan_ref",
                                   RS.rglru_scan)):
        orig = getattr(mod, fn_name)

        def counted(*a, _orig=orig, _w=wrapper, **k):
            _w.launches += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn_name, counted)
    _, tcfg, _, _, _, _, be = _exact_setup("rglru-rglru-local", "local")
    kinds = tcfg.layer_kinds()
    rng = np.random.RandomState(8)
    toks, last = _prompts(tcfg, rng)[0]
    f0, s0 = FA.flash_attention.launches, RS.rglru_scan.launches
    for i, slot in enumerate((0, 2, 1)):
        be.reset_slot(slot)
        be.prefill(toks, slot, last)
        assert FA.flash_attention.launches - f0 == \
            (i + 1) * kinds.count("local")
        assert RS.rglru_scan.launches - s0 == (i + 1) * kinds.count("rglru")
    st = be.graphs.stats()
    assert st["replays"] == 2 and st["captures"] == 1
    assert not be.graphs.warmup_launches


# ------------------------------------------------------------ keys

def _strict_llm(tcfg, tparams, **kw):
    conf = llm.EngineConfig(mb_size=2, num_microbatches=2, strict=True,
                            pool=tkv.PoolConfig(page_size=8), **kw)
    return llm.LLM(tcfg, config=conf, params=tparams, rt=TRT, device="cpu")


@pytest.mark.parametrize("name", ["yi-9b", "local-global"])
def test_strict_auditor_refuses_a_second_prefill_capture(name, stand_in):
    """A serve captures its chunk key, or its exact keys, once and the
    auditor passes; a prefill key captured again mid-serve fails the next
    audit."""
    if name == "yi-9b":
        _, tcfg, _, tparams = _params("yi-9b")
    else:
        _, tcfg, _, tparams = _exact_params(name)
    tl = _strict_llm(tcfg, tparams)
    prompts = [[3 + i for i in range(n)] for n in (12, 14, 11, 13)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=3)
    tl.generate(prompts, sp)
    eng = tl.engine
    kind = "chunk" if name == "yi-9b" else "exact"
    keys = [k for k in eng.backend.graph_entries() if k[0] == kind]
    assert eng.auditor.checks > 0 and keys
    eng.backend.graphs._entries.pop(keys[0])    # dropped mid-serve
    with pytest.raises(InvariantViolation, match="captured 2 times"):
        tl.generate(prompts, sp)


def test_a_reshard_captures_the_prefill_steps_anew(stand_in):
    """A pipe of 2 stages with exact prefill, resharded to 1: the old
    backend's graphs are dropped, the new one captures its own exact keys,
    once each."""
    _, tcfg, _, tparams = _exact_params("local-global")
    tl = _strict_llm(tcfg, tparams, backend="pipelined", n_stages=2)
    eng = tl.engine
    old = eng.backend
    prompts = [[3 + i for i in range(n)] for n in (12, 14, 11, 13)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=3)
    tl.generate(prompts, sp)
    assert ("exact", 16, 1) in old.graph_entries()
    eng.reshard(n_stages=1)
    assert not old.graph_entries() and eng.backend is not old
    tl.generate(prompts, sp)
    new = eng.backend.graph_entries()
    assert ("exact", 16, 0) in new and ("exact", 16, 1) not in new
    assert all(c == 1 for _, c in new.values())


# ------------------------------------------------------------ serve

MAX_NEW = 5
# buckets repeat (40, 8, 32, 16, 40, 8 or 64, 8, 32, 16, 64, 8), so exact
# keys are run eagerly, captured and replayed
LENGTHS = (40, 7, 30, 12, 33, 5)


@pytest.mark.parametrize("arch,backend", [
    ("yi-9b", "pipelined"), ("gemma3-12b", "local"),
    ("recurrentgemma-9b", "pipelined")])
def test_stand_in_prefill_graphs_serve_repro_greedy_streams(arch, backend,
                                                            stand_in):
    """``LLM.generate`` through stand-in graphs, chunked (yi-9b) and exact
    (gemma3-12b, recurrentgemma-9b), local and 2-stage pipelined: the
    greedy streams equal ``repro``'s local engine's token for token, and
    every prefill call is a replay of a key captured once, or a bucket's
    eager first call."""
    jcfg, tcfg, jparams, tparams = _params(arch)
    if arch == "recurrentgemma-9b":         # two periods for two stages
        kw = dict(num_layers=6)
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  TRT, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, tcfg.vocab_size, n)) for n in LENGTHS]
    pool = dict(page_size=8, n_local_pages=64, max_pages_per_seq=16)
    # a fresh JAX slot a request where its reset leaves recurrent state
    # behind (ROADMAP Queue 3)
    jmb = len(prompts) if tcfg.recurrent_layer_count() else 2
    want = jax_llm.LLM(jcfg, config=jax_llm.EngineConfig(
        mb_size=jmb, num_microbatches=1 if jmb > 2 else 2,
        pool=jkv.PoolConfig(**pool)), params=jparams, rt=JRT).generate(
        prompts, JaxSP(temperature=0.0, max_new_tokens=MAX_NEW))
    tl = llm.LLM(tcfg, config=llm.EngineConfig(
        mb_size=2, num_microbatches=2, pool=tkv.PoolConfig(**pool),
        backend=backend, n_stages=2), params=tparams, rt=TRT, device="cpu")
    got = tl.generate(prompts, SamplingParams(temperature=0.0,
                                              max_new_tokens=MAX_NEW))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.finished and w.finished
        assert g.token_ids == w.token_ids, f"request {i}"
    be = tl.engine.backend
    st = be.graphs.stats()
    assert all(n == 1 for n in be.graphs.captures.values())
    kinds = st["replays_by_kind"]
    if tl.engine.chunked_prefill:
        if backend == "local":
            assert kinds["chunk"] == be.prefill_chunks > 0
        else:
            assert kinds["pf-stage"] == be.prefill_stage_runs > 0
            assert kinds["pf-drain"] == be.prefill_drains > 0
    else:
        n = len(be.stage_devices)
        assert kinds["exact"] > 0
        assert kinds["exact"] + st["eager_by_kind"]["exact"] == \
            be.exact_prefills * n == len(prompts) * n
    rep = tl.stats()
    assert rep["graphs"]["prefill_replays"] == st["prefill_replays"] > 0
    assert rep["graphs"]["decode_replays"] == st["decode_replays"] > 0


def test_slot_take_and_put_round_trip_a_row():
    """``slot_take`` copies the row a device index names (rings, states,
    the table row) and passes the pools through; ``slot_put`` writes it
    back into that row only."""
    _, tcfg, _, _ = _exact_params("rglru-rglru-local")
    caches = tkv.build_paged_caches(tcfg, 4, tkv.PoolConfig(page_size=8),
                                    TRT, "cpu")
    tkv.set_page_table(caches, np.arange(4 * 16, dtype=np.int32)
                       .reshape(4, 16))
    slot = torch.tensor([2])
    view = tkv.slot_take(caches, slot, (1, 3))
    assert view["layers"][0] is None and view["layers"][3] is None
    assert torch.equal(view["page_table"], caches["page_table"][2:3])
    for i in (1, 2):
        for name, t in view["layers"][i].items():
            assert t.shape[0] == 1 and not t._is_view()
            t.fill_(7)
    before = _clone(caches)
    tkv.slot_put(caches, slot, view)
    for i, (layer, old) in enumerate(zip(caches["layers"],
                                         before["layers"])):
        for name, t in layer.items():
            if 1 <= i < 3:
                assert torch.all(t[2] == 7)
                assert torch.equal(t[[0, 1, 3]], old[name][[0, 1, 3]])
            else:
                assert torch.equal(t, old[name])
