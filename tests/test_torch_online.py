"""Online serving in the port (``serving.online.OnlineLLM``), the
refcounted page allocator and prefix cache (``serving.kv_cache``) and SLO
admission (``serving.engine.SLOController``) against the JAX package,
float32 on the CPU.

The allocator, the prefix cache and the SLO controller are host Python:
the same call sequences on both packages give the same answers and the
same free lists and refcounts.  Online streams equal offline
``LLM.generate``'s for the same ``(seed, request_id)`` set, with and
without the prefix cache, on both backends, greedy and sampled side by
side; the prefix-cached greedy streams also equal the JAX online
engine's on the same weights (``from_jax_params``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving import online as jax_online  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.llm import LLM, EngineConfig  # noqa: E402
from repro_torch.serving.online import OnlineLLM  # noqa: E402
from repro_torch.serving.request import SamplingParams  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
POOL = dict(page_size=4, n_local_pages=32, n_global_pages=0,
            max_pages_per_seq=8)
OFF_POOL = dict(page_size=4, n_local_pages=24, n_global_pages=8,
                max_pages_per_seq=8)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_arch("yi-9b"))
    tcfg = reduced_config(get_arch("yi-9b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _llm(tcfg, tparams, pool=POOL, **kw):
    base = dict(mb_size=2, num_microbatches=2, pool=tkv.PoolConfig(**pool),
                offload=False, prefill_chunk=4,
                max_prefill_tokens_per_tick=8)
    base.update(kw)
    return LLM(tcfg, config=EngineConfig(**base), params=tparams, rt=TRT,
               device="cpu")


def _mixed(n, new=4):
    pol = [SamplingParams(temperature=0.0, max_new_tokens=new),
           SamplingParams(temperature=1.0, top_k=8, max_new_tokens=new),
           SamplingParams(temperature=0.7, top_p=0.9, max_new_tokens=new),
           SamplingParams(temperature=1.5, max_new_tokens=new)]
    return [pol[i % 4] for i in range(n)]


def _system_prompts(cfg, n=5, head=12, seed=5):
    rng = np.random.RandomState(seed)
    system = [int(t) for t in rng.randint(1, cfg.vocab_size, head)]
    return [system + [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                  rng.randint(3, 10))]
            for _ in range(n)]


# ------------------------------------------------------ allocator refcounts


def test_refcounted_sharing_and_release():
    al = tkv.PageAllocator(tkv.PoolConfig(page_size=4, n_local_pages=8,
                                          max_pages_per_seq=8))
    base = al.allocate(0, 3)
    assert all(al.refcount(p) == 1 for p in base)
    al.adopt(1, base[:2])               # slot 1 shares slot 0's prefix
    al.allocate(1, 1)
    assert al.refcount(base[0]) == 2 and al.refcount(base[2]) == 1
    assert al.pages_of(1)[:2] == base[:2]
    free_before = al.free_local()
    al.release(0)                       # shared pages stay live
    assert al.free_local() == free_before + 1
    assert al.refcount(base[0]) == 1
    al.release(1)
    assert al.free_local() == 7         # page 0 stays scratch


def test_double_release_and_double_free_raise():
    al = tkv.PageAllocator(tkv.PoolConfig(page_size=4, n_local_pages=8,
                                          max_pages_per_seq=8))
    [p] = al.allocate(0, 1)
    al.release(0)
    with pytest.raises(KeyError, match="double release"):
        al.release(0)
    with pytest.raises(KeyError, match="owns no pages"):
        al.release(5)
    with pytest.raises(ValueError, match="double free"):
        al._decref(p)
    with pytest.raises(ValueError, match="twice"):
        al._give_back(p)


def test_adopt_and_retain_validation():
    al = tkv.PageAllocator(tkv.PoolConfig(page_size=4, n_local_pages=8,
                                          max_pages_per_seq=8))
    pages = al.allocate(0, 2)
    free = next(p for p in range(1, 8) if p not in pages)
    with pytest.raises(ValueError, match="not currently owned"):
        al.adopt(1, [free])
    with pytest.raises(ValueError, match="not currently owned"):
        al.retain(free)
    al.adopt(1, pages)
    with pytest.raises(ValueError, match="already owns"):
        al.adopt(1, pages)
    al.retain(pages[0])                 # a cache-style owner
    al.release(0)
    al.release(1)
    assert al.refcount(pages[0]) == 1
    assert al.drop(pages[0]) is True
    assert al.free_local() == 7


# ------------------------------------------------ prefix cache against JAX


def _state(al, pc):
    return (sorted(al._free_local), {k: sorted(v) for k, v in
                                     al._free_global.items()},
            dict(al._refs), {s: list(p) for s, p in al._seq_pages.items()},
            sorted(pc.pages_retained()), pc.hit_requests, pc.miss_requests,
            pc.hit_tokens, pc.evictions, pc.hit_rate)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_prefix_cache_call_sequences_match_jax(seed):
    """A seeded sequence of admissions (match, adopt, allocate with the
    overflow in a global pool), inserts, releases and evictions over
    prompts that share heads, on both packages: the same pages returned,
    the same exceptions, and the same free lists, refcounts and cache
    books after every call."""
    rng = np.random.RandomState(seed)
    kw = dict(page_size=4, n_local_pages=int(rng.randint(6, 16)),
              n_global_pages=int(rng.randint(0, 6)), max_pages_per_seq=8)
    jal, tal = jkv.PageAllocator(jkv.PoolConfig(**kw)), \
        tkv.PageAllocator(tkv.PoolConfig(**kw))
    jpc, tpc = jkv.PrefixCache(jal), tkv.PrefixCache(tal)
    heads = [list(rng.randint(1, 50, 12)) for _ in range(3)]
    live = {}
    for _ in range(rng.randint(5, 40)):
        op = rng.randint(4)
        if op == 0 and len(live) < 6:           # admit a request
            slot = max(live, default=-1) + 1
            prompt = heads[rng.randint(3)][:rng.randint(0, 13)] + \
                list(rng.randint(1, 50, rng.randint(1, 9)))
            gp = int(rng.randint(2)) if kw["n_global_pages"] else None
            shared = jpc.match(prompt)
            assert shared == tpc.match(prompt)
            if shared:
                jal.adopt(slot, shared)
                tal.adopt(slot, shared)
            n = -(-(len(prompt) + 2) // 4) - len(shared)
            got = []
            for al in (jal, tal):
                try:
                    got.append(al.allocate(slot, n, global_pool=gp))
                except MemoryError:
                    got.append("oom")
                    if shared:
                        al.release(slot)
            assert got[0] == got[1]
            if got[0] != "oom":
                live[slot] = prompt
        elif op == 1 and live:                  # a prompt finished
            slot = sorted(live)[rng.randint(len(live))]
            assert jpc.insert(live[slot], jal.pages_of(slot)) == \
                tpc.insert(live[slot], tal.pages_of(slot))
        elif op == 2 and live:                  # a request finished
            slot = sorted(live)[rng.randint(len(live))]
            jal.release(slot)
            tal.release(slot)
            del live[slot]
        elif op == 3:
            n = int(rng.randint(1, 4))
            assert jpc.evict(n) == tpc.evict(n)
        assert _state(jal, jpc) == _state(tal, tpc)
    assert jpc.clear() == tpc.clear()
    assert _state(jal, jpc) == _state(tal, tpc)


def test_prefix_cache_match_insert_evict():
    al = tkv.PageAllocator(tkv.PoolConfig(page_size=4, n_local_pages=16,
                                          max_pages_per_seq=8))
    pc = tkv.PrefixCache(al)
    prompt = list(range(100, 116))      # 16 tokens, 4 pages
    pages = al.allocate(0, 4)
    assert pc.insert(prompt, pages) == 3    # capped at (16 - 1) // 4
    assert all(al.refcount(p) == 2 for p in pages[:3])
    assert pc.match(prompt) == pages[:3]
    assert pc.match(prompt[:9]) == pages[:2]
    assert pc.match([1, 2, 3, 4, 5]) == []
    assert (pc.hit_requests, pc.miss_requests, pc.hit_tokens) == (2, 1, 20)
    other = al.allocate(1, 3)
    assert pc.insert(prompt[:13], other) == 0   # the incumbent wins
    al.release(1)
    al.release(0)
    assert pc.evict(1) == 1             # the LRU leaf goes first
    assert len(pc) == 2 and pc.clear() == 2
    assert al.free_local() == 15


@pytest.mark.parametrize("mod", [jkv, tkv], ids=["jax", "port"])
def test_prefix_cache_rejects_global_pages(mod):
    al = mod.PageAllocator(mod.PoolConfig(page_size=4, n_local_pages=4,
                                          n_global_pages=4,
                                          max_pages_per_seq=8))
    pc = mod.PrefixCache(al)
    pages = al.allocate(0, 5, global_pool=0)    # 3 local + 2 global
    assert pc.insert(list(range(21)), pages) == 3
    assert all(p < 4 for p in pc.pages_retained())


# --------------------------------------------------------------- SLO


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_slo_controller_matches_jax(seed):
    """The same targets and the same tick times: the same ITL estimate and
    budget fraction after every tick, at seeded waits."""
    rng = np.random.RandomState(seed)
    kw = dict(ttft_target_s=float(rng.choice([0.0, 0.5, 2.0])),
              itl_target_s=float(rng.choice([0.0, 0.01, 0.05])),
              floor_frac=float(rng.choice([0.1, 0.25, 1.0])),
              ewma_alpha=float(rng.choice([0.2, 1.0])))
    jc = jax_engine.SLOController(jax_engine.SLOConfig(**kw))
    tc = tengine.SLOController(tengine.SLOConfig(**kw))
    for _ in range(rng.randint(1, 40)):
        dt = float(rng.exponential(0.02))
        jc.observe_tick(dt)
        tc.observe_tick(dt)
        wait = float(rng.uniform(0, 2))
        assert jc.itl_ewma == tc.itl_ewma
        assert jc.budget_frac(wait) == tc.budget_frac(wait)


def test_slo_controller_budget_shaping():
    with pytest.raises(ValueError, match="floor_frac"):
        tengine.SLOController(tengine.SLOConfig(floor_frac=0.0))
    with pytest.raises(ValueError, match=">= 0"):
        tengine.SLOController(tengine.SLOConfig(ttft_target_s=-1.0))
    c = tengine.SLOController(tengine.SLOConfig(itl_target_s=0.1,
                                                floor_frac=0.25,
                                                ewma_alpha=1.0))
    c.observe_tick(0.05)
    assert c.budget_frac(0.0) == 1.0
    c.observe_tick(0.2)
    assert c.budget_frac(0.0) == pytest.approx(0.5)
    c.observe_tick(10.0)
    assert c.budget_frac(0.0) == 0.25
    c = tengine.SLOController(tengine.SLOConfig(
        ttft_target_s=1.0, itl_target_s=0.1, ewma_alpha=1.0))
    c.observe_tick(10.0)
    assert c.budget_frac(0.1) < 1.0 and c.budget_frac(0.5) == 1.0


def test_slo_narrows_engine_admission(model):
    _, _, tcfg, tparams = model
    eng = _llm(tcfg, tparams, slo=tengine.SLOConfig(
        itl_target_s=0.1, ewma_alpha=1.0)).engine
    assert eng.prefill_rows == 2 and eng._tick_prefill_rows() == 2
    eng.slo.observe_tick(0.4)           # ITL 4x the target: a quarter
    assert eng._tick_prefill_rows() == 1


# ---------------------------------------------------- engine-level hits


def test_prefix_hits_share_blocks_and_skip_prefill(model):
    _, _, tcfg, tparams = model
    system = list(range(50, 62))        # 12 tokens, 3 full pages
    p1, p2 = system + [7, 8, 9, 10], system + [11, 12, 13]
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    tl = _llm(tcfg, tparams, prefix_cache=True)
    eng = tl.engine
    [o1] = tl.generate([p1], sp)
    assert eng.stats.prefix_hits == 0
    cached = eng.prefix_cache.pages_retained()
    assert len(cached) == 3
    assert all(eng.alloc.refcount(p) == 1 for p in cached)
    [o2] = tl.generate([p2], sp)
    assert eng.stats.prefix_hits == 1
    assert eng.stats.prefix_hit_tokens == 12
    assert eng.stats.prefill_tokens == len(p1) + len(p2) - 12
    assert all(eng.alloc.refcount(p) == 1 for p in cached)
    assert eng.prefix_cache.hit_rate == 0.5
    rep = tl.stats()
    assert (rep["prefix_hits"], rep["prefix_hit_tokens"]) == (1, 12)
    ref = _llm(tcfg, tparams)
    assert o1.token_ids == ref.generate([p1], sp)[0].token_ids
    assert o2.token_ids == ref.generate([p2], sp)[0].token_ids
    eng.prefix_cache.clear()
    assert eng.alloc.free_local() == POOL["n_local_pages"] - 1


def test_prefix_cache_evicts_under_pool_pressure(model):
    _, _, tcfg, tparams = model
    small = dict(page_size=4, n_local_pages=8, max_pages_per_seq=8)
    sp = SamplingParams(temperature=0.0, max_new_tokens=2)
    tl = _llm(tcfg, tparams, pool=small, prefix_cache=True, mb_size=1,
              num_microbatches=1)
    eng = tl.engine
    tl.generate([list(range(10, 22))], sp)
    tl.generate([list(range(30, 42))], sp)
    assert len(eng.prefix_cache) > 0
    [out] = tl.generate([list(range(60, 74))], sp)
    assert out.finished and eng.prefix_cache.evictions > 0


def test_engine_gates_prefix_cache_on_chunked_prefill(model):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="chunked"):
        tengine.OfflineEngine(tcfg, tparams, TRT, prefix_cache=True,
                              prefill_mode="exact", device="cpu")


# ------------------------------------------------------- streaming


def test_stream_delivers_before_later_submission_finishes(model):
    _, _, tcfg, tparams = model
    p1, p2 = list(range(40, 52)), list(range(60, 70))
    sp = SamplingParams(temperature=0.0, max_new_tokens=5)
    online = OnlineLLM(llm=_llm(tcfg, tparams))
    s1 = online.submit(p1, sp)
    ev = s1.next_event()                # cooperative: steps here
    assert ev is not None and ev.index == 0
    s2 = online.submit(p2, sp)          # joins the live loop
    assert not s2.finished
    ev2 = s1.next_event()
    assert ev2 is not None and ev2.index == 1
    assert s1.tokens() == [ev.token, ev2.token]
    out1, out2 = s1.result(), s2.result()
    assert out1.finished and out2.finished
    assert s1.ttft_s is not None and s1.ttft_s > 0
    assert len(s1.inter_token_s()) == len(out1.token_ids) - 1
    assert out1.finish_reason == "length"
    ref = _llm(tcfg, tparams).generate([p1, p2], sp)
    assert out1.token_ids == ref[0].token_ids
    assert out2.token_ids == ref[1].token_ids


def test_threaded_pump_streams_and_closes(model):
    _, _, tcfg, tparams = model
    prompts = _system_prompts(tcfg, n=4)
    sps = _mixed(4)
    with OnlineLLM(llm=_llm(tcfg, tparams)).start() as online:
        assert online._thread.name == "online-pump"
        streams = [online.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = [s.result() for s in streams]
        thread = online._thread
        assert online.close(timeout=10.0)
    assert not thread.is_alive()
    ref = _llm(tcfg, tparams).generate(prompts, sps)
    assert [o.token_ids for o in outs] == [o.token_ids for o in ref]


def test_pump_hands_engine_errors_to_the_consumer(model):
    _, _, tcfg, tparams = model
    online = OnlineLLM(llm=_llm(tcfg, tparams))

    def broken():
        raise MemoryError("injected engine failure")
    online.engine.step = broken
    online.start()
    stream = online.submit([1, 2, 3], SamplingParams(max_new_tokens=2))
    with pytest.raises(RuntimeError, match="online pump") as err:
        stream.next_event(timeout=10.0)
    assert isinstance(err.value.__cause__, MemoryError)
    assert online.close(timeout=10.0)


def _run_online(tcfg, tparams, prompts, sps, **kw):
    online = OnlineLLM(llm=_llm(tcfg, tparams, **kw))
    streams = [online.submit(p, sp) for p, sp in zip(prompts, sps)]
    outs = [s.result() for s in streams]
    assert all(o.finished for o in outs)
    return [o.token_ids for o in outs], online


@pytest.mark.parametrize("backend", ["local", "pipelined"])
def test_online_equals_offline(model, backend):
    """Streamed online outputs equal offline ``LLM.generate``'s for the
    same (seed, request_id) set: mixed sampling, with and without the
    prefix cache and SLO admission, on both backends (offloaded pools, a
    shared 12-token system prompt so that the cached run shares
    blocks)."""
    _, _, tcfg, tparams = model
    prompts, sps = _system_prompts(tcfg), _mixed(5)
    common = dict(pool=OFF_POOL, offload=True, backend=backend, n_stages=1)
    ref = [o.token_ids for o in
           _llm(tcfg, tparams, **common).generate(prompts, sps)]
    got, _ = _run_online(tcfg, tparams, prompts, sps, **common)
    assert got == ref
    got, online = _run_online(tcfg, tparams, prompts, sps,
                              prefix_cache=True, **common)
    assert got == ref
    assert online.stats()["prefix_hits"] > 0
    got, _ = _run_online(tcfg, tparams, prompts, sps,
                         slo=tengine.SLOConfig(ttft_target_s=0.5,
                                               itl_target_s=0.005),
                         **common)
    assert got == ref


def test_prefix_cached_online_matches_jax(model):
    """Greedy, prefix-cached, online, local backend: the port's streams
    and prefix books equal the JAX online engine's."""
    jcfg, jparams, tcfg, tparams = model
    prompts = _system_prompts(tcfg)
    conf = dict(mb_size=2, num_microbatches=2, offload=True,
                prefill_chunk=4, max_prefill_tokens_per_tick=8,
                prefix_cache=True)
    jon = jax_online.OnlineLLM(llm=jax_llm.LLM(
        jcfg, params=jparams, rt=JRT, config=jax_llm.EngineConfig(
            pool=jkv.PoolConfig(**OFF_POOL), **conf)))
    jsp = JaxSP(temperature=0.0, max_new_tokens=4)
    want = [s.result().token_ids for s in
            [jon.submit(p, jsp) for p in prompts]]
    got, online = _run_online(
        tcfg, tparams, prompts,
        [SamplingParams(temperature=0.0, max_new_tokens=4)] * len(prompts),
        pool=OFF_POOL, **conf)
    assert got == want
    js, ts = jon.engine.stats, online.engine.stats
    assert (ts.prefix_hits, ts.prefix_hit_tokens, ts.prefill_tokens) == \
        (js.prefix_hits, js.prefix_hit_tokens, js.prefill_tokens)


def test_serve_cli_online_prefix_cache():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--online",
         "--prefix-cache", "--system-prompt", "32", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "finished 16/16 requests" in r.stdout
    assert "prefix cache: 15 hits" in r.stdout
