"""DeServe §4.2 in the port (``repro_torch.core.offload``, the global pools
of ``repro_torch.serving.kv_cache`` and the engine's parity bookkeeping)
against the JAX package, float32 on the CPU.

The capacity formulas and the allocator are host arithmetic and must agree
exactly.  The offloader is run on the same swap sequence in both packages
with the same data written into each resident slice; the pools must be
bit-identical after every swap, with equal ``swap_count`` and
``bytes_swapped``.  Engines with global pools, set by hand or planned,
must give the same greedy streams and the same swap books as the JAX
engine on the same weights.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.core import offload as JOF  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core import offload as TOF  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.request import SamplingParams  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)


# ---------------------------------------------------------------- formulas

@pytest.mark.parametrize("m_kv,m_g,n_b", [
    (8e9, 1e9, 8), (8e9, 5e9, 3), (1e8, 1e6, 64), (4 * 2 ** 30, 1.2e9, 6),
    (2e9, 0.0, 2)])
def test_formulas_match_jax(m_kv, m_g, n_b):
    assert TOF.global_pool_bytes(16e9, 0.08) == JOF.global_pool_bytes(16e9,
                                                                      0.08)
    assert TOF.per_microbatch_capacity(m_kv, m_g, n_b) == \
        JOF.per_microbatch_capacity(m_kv, m_g, n_b)
    assert TOF.per_microbatch_capacity_no_offload(m_kv, n_b) == \
        JOF.per_microbatch_capacity_no_offload(m_kv, n_b)
    cap = TOF.per_microbatch_capacity(m_kv, m_g, n_b)
    for seq in (1.0, 15.7e6, 1e8, 1e12):
        assert TOF.batch_size_from_capacity(cap, seq) == \
            JOF.batch_size_from_capacity(cap, seq)
    # Formula 1's floor: never below M_G, whatever N_B
    assert cap >= min(m_g, m_kv / 2)
    assert TOF.PCIE4_BW == JOF.PCIE4_BW


@pytest.mark.parametrize("kw", [
    dict(m_kv_bytes=32.0 * 4096, page_bytes=4096, page_size=8,
         max_pages_per_seq=4, bandwidth=40.0 * 4096, stage_time=0.1,
         n_microbatches=4),
    dict(m_kv_bytes=4 * 2 ** 30, page_bytes=1572864, page_size=16,
         max_pages_per_seq=64, bandwidth=25e9, stage_time=0.02,
         n_microbatches=6),
    dict(m_kv_bytes=1e6, page_bytes=1000, page_size=4, max_pages_per_seq=8,
         bandwidth=1e9, stage_time=1.0, n_microbatches=2)])
def test_offload_plan_matches_jax(kw):
    got, want = TOF.OffloadPlan.derive(**kw), JOF.OffloadPlan.derive(**kw)
    assert dataclasses.asdict(got.pool) == dataclasses.asdict(want.pool)
    assert got.m_g_bytes == want.m_g_bytes
    assert got.m_kv_bytes == want.m_kv_bytes
    assert got.capacity_with_offload() == want.capacity_with_offload()
    assert got.capacity_without_offload() == want.capacity_without_offload()


def test_pool_geometry_matches_jax():
    for kw in (dict(page_size=4, n_local_pages=5, n_global_pages=2),
               dict(page_size=16, n_local_pages=400, n_global_pages=400)):
        t, j = tkv.PoolConfig(**kw), jkv.PoolConfig(**kw)
        assert t.n_pages == j.n_pages
        for pid in (0, 1):
            assert t.global_range(pid) == j.global_range(pid)
            assert tkv.global_slice(t, pid) == jkv.global_slice(j, pid)
    for arch in ("yi-9b", "gemma3-12b", "recurrentgemma-9b"):
        for page in (8, 16):
            t = tkv.kv_bytes_per_page(get_arch(arch),
                                      tkv.PoolConfig(page_size=page))
            assert t == jkv.kv_bytes_per_page(jax_get_arch(arch),
                                              jkv.PoolConfig(page_size=page))
    # yi-9b's full-width page across its 48 layers, bf16
    assert tkv.kv_bytes_per_page(get_arch("yi-9b"),
                                 tkv.PoolConfig(page_size=16)) == 1572864


# --------------------------------------------------------------- allocator

def _both(kw):
    return (tkv.PageAllocator(tkv.PoolConfig(**kw)),
            jkv.PageAllocator(jkv.PoolConfig(**kw)))


def _same_state(t, j):
    assert t.free_local() == j.free_local()
    for pid in (0, 1):
        assert t.free_global(pid) == j.free_global(pid)


def _grant(al, slot, n, gp):
    try:
        return al.allocate(slot, n, global_pool=gp)
    except MemoryError:
        return "MemoryError"


# the allocation scripts of tests/test_serving.py:19-50 and a churn script
SCRIPTS = [
    (dict(page_size=4, n_local_pages=5, n_global_pages=2, max_pages_per_seq=8),
     [("alloc", 0, 3, None), ("alloc", 1, 6, 0), ("release", 0),
      ("alloc", 2, 5, 1), ("alloc", 3, 2, 0)]),
    (dict(page_size=4, n_local_pages=2, n_global_pages=3, max_pages_per_seq=8),
     [("alloc", 0, 3, 0), ("alloc", 1, 2, 1), ("release", 0),
      ("alloc", 4, 4, 0), ("alloc", 5, 2, 1), ("extend", 1, 1),
      ("extend", 4, 0), ("release", 1), ("extend", 5, 1)]),
    (dict(page_size=8, n_local_pages=6, n_global_pages=4,
          max_pages_per_seq=16),
     [("alloc", s, 1 + s % 4, s % 2) for s in range(8)]
     + [("release", s) for s in (1, 4, 6)]
     + [("alloc", 10 + s, 3, s % 2) for s in range(4)]
     + [("extend", 0, 0), ("extend", 3, 1)]),
]


@pytest.mark.parametrize("kw,script", SCRIPTS)
def test_allocator_global_lists_match_jax(kw, script):
    t, j = _both(kw)
    for op in script:
        if op[0] == "alloc":
            assert _grant(t, *op[1:]) == _grant(j, *op[1:]), op
        elif op[0] == "extend":
            _, slot, gp = op
            try:
                want = j.extend(slot, global_pool=gp)
            except MemoryError:
                with pytest.raises(MemoryError):
                    t.extend(slot, global_pool=gp)
            else:
                assert t.extend(slot, global_pool=gp) == want
        elif j.pages_of(op[1]):
            t.release(op[1])
            j.release(op[1])
        else:                               # its allocation was refused
            with pytest.raises(KeyError):
                t.release(op[1])
        _same_state(t, j)
        for slot in range(16):
            assert list(t.table_row(slot)) == list(j.table_row(slot))
    pool = tkv.PoolConfig(**kw)
    g0, g1 = set(pool.global_range(0)), set(pool.global_range(1))
    for slot in range(16):
        pages = set(t.pages_of(slot))
        assert not (pages & g0 and pages & g1)      # one parity a slot


def test_allocator_refuses_double_release():
    t = tkv.PageAllocator(tkv.PoolConfig(page_size=4, n_local_pages=4,
                                         n_global_pages=2))
    t.allocate(0, 4, global_pool=1)
    t.release(0)
    with pytest.raises(KeyError):
        t.release(0)
    with pytest.raises(ValueError, match="twice"):
        t._give_back(t.pool.global_range(1)[0])


def test_reference_parity_pools_are_shared_between_microbatches():
    """Microbatches 0 and 2 draw global pages from one free list, although
    the offloader swaps the whole G0 slice between them: once microbatch 0
    holds G0, microbatch 2 cannot get one page while G1 still has three.
    Both packages behave so (the port reproduces the reference, ROADMAP
    Queue 3); Formula 1 credits each microbatch with the whole M_G."""
    kw = dict(page_size=4, n_local_pages=2, n_global_pages=3,
              max_pages_per_seq=8)
    for al in _both(kw):
        pool = al.pool
        got = al.allocate(0, 4, global_pool=0)        # microbatch 0
        assert sum(p < pool.n_local_pages for p in got) == 1
        assert set(got) - {1} == set(pool.global_range(0))
        with pytest.raises(MemoryError):
            al.allocate(2, 1, global_pool=0)         # microbatch 2
        assert al.free_global(1) == 3
        assert al.free_local() == 0 and al.free_global(0) == 0


# --------------------------------------------------------------- offloader

def jax_layer_caches(jc, cfg):
    """The JAX cache tree as the port's per-layer list: scan leaves are
    stacked over periods, layer order is period by period, then the
    tail."""
    period = len(cfg.block_pattern)
    n_periods = cfg.num_layers // period
    layers = [{k: np.asarray(a[p]) for k, a in jc["scan"][i].items()}
              for p in range(n_periods) for i in range(period)]
    layers += [{k: np.asarray(a) for k, a in c.items()} for c in jc["tail"]]
    return layers


def _write_jax(jc, cfg, sl, data):
    """Write ``data[layer][name]`` into the slice ``sl`` of every paged
    layer's pools of the JAX cache tree (layers in the port's order)."""
    period = len(cfg.block_pattern)
    n_periods = cfg.num_layers // period
    scan = list(jc["scan"])
    for i, c in enumerate(scan):
        if "k_pages" not in c:
            continue
        c = dict(c)
        for name in ("k_pages", "v_pages"):
            stacked = np.stack([data[p * period + i][name]
                                for p in range(n_periods)])
            c[name] = c[name].at[:, sl].set(jnp.asarray(stacked))
        scan[i] = c
    tail = list(jc["tail"])
    for i, c in enumerate(tail):
        if "k_pages" in c:
            idx = n_periods * period + i
            tail[i] = {**c, **{name: c[name].at[sl].set(
                jnp.asarray(data[idx][name])) for name in ("k_pages",
                                                          "v_pages")}}
    return {**jc, "scan": scan, "tail": tail}


def _run_swaps(arch, pool_kw, sequence, async_swap):
    """Drive both offloaders through ``sequence`` of microbatches; after
    each swap, write fresh random data into the resident slice of both
    packages' pools and check that every pool is bit-identical."""
    jcfg = jax_reduced(jax_get_arch(arch))
    tcfg = reduced_config(get_arch(arch))
    jpool, tpool = jkv.PoolConfig(**pool_kw), tkv.PoolConfig(**pool_kw)
    jc = jkv.build_paged_caches(jcfg, 2, jpool, JRT)
    tc = tkv.build_paged_caches(tcfg, 2, tpool, TRT, device="cpu")
    joff = JOF.DoubleBufferOffloader(jpool, 4, async_swap=async_swap)
    toff = TOF.DoubleBufferOffloader(tpool, 4, async_swap=async_swap)
    rng = np.random.RandomState(3)
    paged = [i for i, k in enumerate(tcfg.layer_kinds()) if k in
             ("attn", "global")]
    for mb in sequence:
        jc = joff.ensure_resident(jc, mb)
        tc = toff.ensure_resident(tc, mb)
        assert mb not in toff._host                  # swap-in popped it
        joff.settle()          # the JAX async swap-out books its bytes on
        assert joff.resident == toff.resident        # its copy worker
        assert (joff.swap_count, joff.bytes_swapped) == \
            (toff.swap_count, toff.bytes_swapped)
        sl = tkv.global_slice(tpool, mb % 2)
        shape = tuple(tc["layers"][paged[0]]["k_pages"][sl].shape)
        data = {i: {n: rng.standard_normal(shape).astype(np.float32)
                    for n in ("k_pages", "v_pages")} for i in paged}
        jc = _write_jax(jc, jcfg, sl, data)
        for i in paged:
            for n in ("k_pages", "v_pages"):
                tc["layers"][i][n][sl] = torch.from_numpy(data[i][n])
        jl = jax_layer_caches(jc, jcfg)
        for i in paged:
            for n in ("k_pages", "v_pages"):
                np.testing.assert_array_equal(tc["layers"][i][n].numpy(),
                                              jl[i][n])
    joff.settle()
    toff.settle()
    return toff


@pytest.mark.parametrize("async_swap", [True, False])
@pytest.mark.parametrize("sequence", [
    (0, 2, 0, 2, 0),                       # tests/test_serving.py:211
    (0, 1, 2, 3) * 3,                      # N_B = 4 round robin
    (0, 0, 1, 3, 3, 2, 1, 0, 2),           # repeats and both parities
])
def test_offloader_swaps_match_jax_bit_for_bit(sequence, async_swap):
    pool_kw = dict(page_size=4, n_local_pages=4, n_global_pages=3,
                   max_pages_per_seq=6)
    toff = _run_swaps("yi-9b", pool_kw, sequence, async_swap)
    assert toff.swap_count > 0 and toff.bytes_swapped > 0


def test_offloader_roundtrip_preserves_content():
    """tests/test_serving.py:183 on the port: a signature written for
    microbatch 0 leaves with it and comes back with it."""
    cfg = reduced_config(get_arch("yi-9b"))
    pool = tkv.PoolConfig(page_size=4, n_local_pages=4, n_global_pages=3,
                          max_pages_per_seq=6)
    caches = tkv.build_paged_caches(cfg, 2, pool, TRT, device="cpu")
    sl = tkv.global_slice(pool, 0)
    for layer in caches["layers"]:
        layer["k_pages"][sl.start] = 3.25
    off = TOF.DoubleBufferOffloader(pool, num_microbatches=4)
    caches = off.ensure_resident(caches, 0)        # adopt mb 0 (no prior)
    caches = off.ensure_resident(caches, 2)        # mb 0 out, mb 2 in
    assert all(not (layer["k_pages"][sl.start] == 3.25).any()
               for layer in caches["layers"])
    caches = off.ensure_resident(caches, 0)        # mb 0 back in
    assert all((layer["k_pages"][sl.start] == 3.25).all()
               for layer in caches["layers"])
    assert off.swap_count == 3 and off.bytes_swapped > 0
    # one host buffer a microbatch that left, reused on its next swap-out
    assert set(off._buffers) == {0, 2}
    assert off.host_bytes == 2 * sum(
        layer[n][sl].numel() * 4 for layer in caches["layers"]
        for n in ("k_pages", "v_pages"))
    assert off.swap_timings() == ([], [])            # none timed off-card


def test_offloader_without_global_pages_never_swaps():
    cfg = reduced_config(get_arch("yi-9b"))
    pool = tkv.PoolConfig(page_size=4, n_local_pages=8)
    caches = tkv.build_paged_caches(cfg, 2, pool, TRT, device="cpu")
    off = TOF.DoubleBufferOffloader(pool, 4)
    for mb in (0, 1, 2, 3):
        assert off.ensure_resident(caches, mb) is caches
    assert off.swap_count == 0 and off.bytes_swapped == 0


# ----------------------------------------------------------------- engines

MAX_NEW = 6
LENGTHS = (40, 7, 30, 12, 33, 5, 21, 17)


def setup(arch):
    jcfg = jax_reduced(jax_get_arch(arch))
    tcfg = reduced_config(get_arch(arch))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, tcfg.vocab_size, n)) for n in LENGTHS]
    return jcfg, tcfg, jparams, tparams, prompts


def _serve_both(arch, jax_config, port_config, lengths=None):
    jcfg, tcfg, jparams, tparams, prompts = setup(arch)
    if lengths is not None:
        prompts = [p[:n] for p, n in zip(prompts, lengths)]
    jl = jax_llm.LLM(jcfg, config=jax_config, params=jparams, rt=JRT)
    tl = llm.LLM(tcfg, config=port_config, params=tparams, rt=TRT,
                 device="cpu")
    want = jl.generate(prompts, JaxSP(temperature=0.0,
                                      max_new_tokens=MAX_NEW))
    got = tl.generate(prompts, SamplingParams(temperature=0.0,
                                              max_new_tokens=MAX_NEW))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.finished and w.finished
        assert g.token_ids == w.token_ids, f"request {i}"
    joff, toff = jl.engine._offloader, tl.engine.backend.offloader
    assert toff is not None and joff is not None
    assert toff.swap_count == joff.swap_count > 0
    assert toff.bytes_swapped == joff.bytes_swapped > 0
    assert tl.stats()["swaps"] == toff.swap_count
    return jl, tl


# yi-9b takes chunked prefill, gemma3-1b (reduced: one global layer among
# eight local ones, window 32) exact prefill with the global layer paged
@pytest.mark.parametrize("arch,mode", [("yi-9b", "auto"),
                                       ("gemma3-1b", "auto"),
                                       ("yi-9b", "exact")])
def test_hand_set_global_pools_serve_as_jax(arch, mode):
    """Six local pages and twelve a global pool over 2 x 4 slots: most
    requests overflow into their microbatch's parity, every decode tick
    swaps, and prompts wait for pages (head-of-line retries)."""
    kw = dict(page_size=8, n_local_pages=6, n_global_pages=12,
              max_pages_per_seq=16)
    jconf = jax_llm.EngineConfig(mb_size=2, num_microbatches=4,
                                 pool=jkv.PoolConfig(**kw),
                                 prefill_mode=mode)
    tconf = llm.EngineConfig(mb_size=2, num_microbatches=4,
                             pool=tkv.PoolConfig(**kw), prefill_mode=mode)
    _, tl = _serve_both(arch, jconf, tconf)
    assert tl.engine.chunked_prefill == (arch == "yi-9b" and mode == "auto")


def _plan_kw(tcfg):
    pb = tkv.kv_bytes_per_page(tcfg, tkv.PoolConfig(page_size=8),
                               dtype_bytes=4)
    # tests/test_llm.py:257's plan with a longer link: N_B >= 3, and a
    # global pool of 4 pages a parity
    return dict(n_stages=2, stage_time=0.1, latency=0.1,
                m_kv_bytes=32.0 * pb, bandwidth=40.0 * pb, page_size=8,
                max_pages_per_seq=4, mb_size_cap=2, max_microbatches=8)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-1b"])
def test_planned_engine_matches_jax(arch):
    tcfg = reduced_config(get_arch(arch))
    kw = _plan_kw(tcfg)
    jl, tl = _serve_both(arch, jax_llm.EngineConfig.plan(**kw),
                         llm.EngineConfig.plan(**kw),
                         lengths=[min(n, 20) for n in LENGTHS])
    je, te = jl.engine, tl.engine
    assert dataclasses.asdict(te.schedule_choice) == \
        dataclasses.asdict(je.schedule_choice)
    assert dataclasses.asdict(te.pool) == dataclasses.asdict(je.pool)
    assert te.pool.n_global_pages > 0
    assert te.schedule_choice.n_microbatches == te.num_microbatches == \
        je.num_microbatches >= 3            # mb 0 and mb 2 share parity 0
    assert (te.mb_size, te.prefill_chunk, te.prefill_rows) == \
        (je.mb_size, je.prefill_chunk, je.prefill_rows)


def test_from_plan_honours_a_schedule_choice():
    """tests/test_backend.py:82 on the port: a precomputed choice is taken
    as it is, and the planned engine serves."""
    from repro_torch.core.scheduler import ScheduleChoice
    from repro_torch.serving.engine import OfflineEngine
    _, tcfg, _, tparams, prompts = setup("yi-9b")
    choice = ScheduleChoice(n_microbatches=3, per_mb_batch=2,
                            per_mb_kv_bytes=0.0, utilisation=1.0,
                            offload=True)
    pb = tkv.kv_bytes_per_page(tcfg, tkv.PoolConfig(page_size=8),
                               dtype_bytes=4)
    eng = OfflineEngine.from_plan(
        tcfg, tparams, TRT, n_stages=2, stage_time=0.1, latency=0.05,
        m_kv_bytes=64.0 * pb, bandwidth=160.0 * pb, page_size=8,
        max_pages_per_seq=4, choice=choice, device="cpu")
    assert eng.schedule_choice is choice
    assert (eng.num_microbatches, eng.mb_size) == (3, 2)
    assert eng.pool.n_global_pages > 0 and eng.backend.offloader is not None
    from repro_torch.serving.request import Request
    sp = SamplingParams(temperature=0.0, max_new_tokens=3)
    eng.submit([Request(i, p[:4], sp) for i, p in enumerate(prompts[:4])])
    assert len(eng.run(max_steps=200)) == 4


def test_from_plan_refuses_an_arch_without_paged_layers():
    from repro_torch.serving.engine import OfflineEngine, prefill_chunk_cap
    cfg = reduced_config(get_arch("recurrentgemma-9b"))
    with pytest.raises(ValueError, match="paged-attention"):
        OfflineEngine.from_plan(cfg, {}, TRT, n_stages=2, stage_time=0.1,
                                latency=0.1, m_kv_bytes=1e6, device="cpu")
    # no link, nothing to cap (links come with the pipeline slice)
    assert prefill_chunk_cap(cfg, TRT, None, stage_time=0.1) == 0


def test_offload_false_keeps_the_global_pages_resident():
    """``EngineConfig(offload=False)``: the global pages are allocated but
    never swapped (the reference's semantics)."""
    _, tcfg, _, tparams, prompts = setup("yi-9b")
    pool = tkv.PoolConfig(page_size=8, n_local_pages=6, n_global_pages=12,
                          max_pages_per_seq=16)
    outs = {}
    for offload in (True, False):
        tl = llm.LLM(tcfg, config=llm.EngineConfig(
            mb_size=2, num_microbatches=4, pool=pool, offload=offload),
            params=tparams, rt=TRT, device="cpu")
        outs[offload] = [o.token_ids for o in tl.generate(
            prompts[:4], SamplingParams(temperature=0.0,
                                        max_new_tokens=MAX_NEW))]
        assert (tl.engine.backend.offloader is None) == (not offload)
    assert outs[True] == outs[False]
