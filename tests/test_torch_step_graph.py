"""The captured decode steps (``repro_torch.serving.step_graph``) and the
static-buffer decode path of both backends, float32 on the CPU.

On the CPU a step runs eagerly through the same static inputs and outputs
that a captured graph reads and writes on the card (the routing rule), so
these tests hold that path against the eager step it replaced, bit for
bit, and against ``repro``'s greedy streams.  ``CPUGraphs`` stands in for
the card's graphs: its "capture" runs the step once (as a capture records
it) and its "replay" runs it again, so the warm-up, the state restore, the
launch books and the strict auditor's pins are exercised here too.  The
paged kernel's workspace sizing and pin are host arithmetic and are
tested directly.  On the card ``chip_smoke.py`` holds real replays
against the eager step (``[graph-parity]``).
"""

import contextlib
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch.analysis.invariants import InvariantViolation  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.kernels import groups  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving import step_graph  # noqa: E402
from repro_torch.serving.request import SamplingParams  # noqa: E402
from repro_torch.serving.sampler import RowSampling, gumbel_noise  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
CPU = torch.device("cpu")


class _Replay:
    """A graph's stand-in: a replay runs the step again; the wrappers'
    Python does not run in a real replay, so their counters stay put."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        counts = step_graph._counts()
        self.step()
        step_graph._set_counts(counts)


class CPUGraphs(step_graph.StepGraphs):
    """The card's graphs stood in on the CPU: a capture runs the step once
    (the caller then restores the recurrent rows, as after the warm-up)
    and a replay runs it again."""

    capture_runs_step = True

    def graphed(self, device):
        return True

    def _new_graph(self, device, step):
        step()
        return _Replay(step)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(backend_mod, "StepGraphs", CPUGraphs)


def _params(arch):
    jcfg = jax_reduced(jax_get_arch(arch))
    tcfg = reduced_config(get_arch(arch))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


# ------------------------------------------------------------ tick level

def _clone(caches):
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       for layer in caches["layers"]],
            "page_table": caches["page_table"].clone()}


def _assert_caches_equal(got, want):
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for name in g:
            assert torch.equal(g[name], w[name]), f"layer {i} {name}"


def _filled(tcfg, batch, seed):
    """Engine caches over ``batch`` rows of 4 pages of 8, every row its own
    pages, the pools and recurrent states random (rings stay empty)."""
    pool = tkv.PoolConfig(page_size=8, n_local_pages=batch * 4 + 1,
                          max_pages_per_seq=4)
    caches = tkv.build_paged_caches(tcfg, batch, pool, TRT, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for layer in caches["layers"]:
        for name, t in layer.items():
            if name in ("k_pages", "v_pages") or "pos" not in layer:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    tkv.set_page_table(caches, 1 + np.arange(batch * 4, dtype=np.int32)
                       .reshape(batch, 4))
    return pool, caches


def _samp(rng, mb, step):
    """Row 0 greedy, the rest sampled (temperature, top-k, top-p)."""
    temp = np.full((mb,), 0.8, np.float32)
    temp[0] = 0.0
    return RowSampling(keys=np.arange(mb, dtype=np.int64) + 7,
                       steps=np.full((mb,), step, np.int32), temp=temp,
                       top_k=np.array([0] + [5] * (mb - 1), np.int32),
                       top_p=np.full((mb,), 0.9, np.float32))


@pytest.mark.parametrize("graphs", ["eager", "stand-in"])
@pytest.mark.parametrize("arch", ["yi-9b", "recurrentgemma-9b"])
def test_local_step_equals_the_eager_step(arch, graphs, monkeypatch):
    """Six ticks over two microbatches, greedy and mixed rows: the
    static-buffer step's tokens, log-probs and every cache leaf equal
    ``_decode_fn``'s on a copy of the caches, bit for bit (the stand-in's
    warm-up and capture must leave the recurrent states as they found
    them)."""
    if graphs == "stand-in":
        monkeypatch.setattr(backend_mod, "StepGraphs", CPUGraphs)
    _, tcfg, _, tparams = _params(arch)
    mb_size, n_b = 2, 2
    pool, caches = _filled(tcfg, mb_size * n_b, 3)
    be = backend_mod.LocalBackend(tcfg, tparams, TRT, mb_size=mb_size,
                                  num_microbatches=n_b, pool=pool,
                                  device=CPU, caches=caches)
    ref = _clone(caches)
    gen = torch.Generator()
    rng = np.random.RandomState(0)
    for t in range(6):
        mb = t % n_b
        tokens = rng.randint(1, tcfg.vocab_size, mb_size).astype(np.int32)
        pos = np.array([9 + t, 17 + t], np.int32)
        samp = _samp(rng, mb_size, t) if t % 3 else RowSampling(
            keys=np.zeros(mb_size, np.int64), steps=np.zeros(mb_size,
                                                             np.int32),
            temp=np.zeros(mb_size, np.float32),
            top_k=np.zeros(mb_size, np.int32),
            top_p=np.ones(mb_size, np.float32))
        (res,) = be.decode(mb, tokens, pos, samp)
        sampled = samp.any_sampled
        noise = gumbel_noise(samp, tcfg.vocab_size, CPU, gen) \
            if sampled else None
        toks, lps = backend_mod.LocalBackend._decode_fn(
            tparams, ref, torch.from_numpy(tokens), torch.from_numpy(pos),
            mb * mb_size, noise, torch.from_numpy(samp.temp),
            torch.from_numpy(samp.top_k), torch.from_numpy(samp.top_p),
            cfg=tcfg, rt=TRT, mb_size=mb_size, sampled=sampled)
        assert res.mb == mb
        np.testing.assert_array_equal(res.tokens, toks.numpy())
        np.testing.assert_array_equal(res.logprobs, lps.numpy())
        _assert_caches_equal(be.caches, ref)
    if graphs == "stand-in":
        st = be.graphs.stats()
        # (mb 0 | 1) x (greedy | sampled), each captured once
        assert st["keys"] == st["captures"] == 4
        assert st["replays"] == be.decode_ticks == 6


@pytest.mark.parametrize("graphs", ["eager", "stand-in"])
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_pipelined_steps_equal_the_eager_tick(wire, graphs, monkeypatch):
    """Two stages, three microbatches, mixed greedy and sampled rows,
    fill, steady state and drain: the static-buffer stages and drain give
    ``pipeline_decode_tick``'s tokens, log-probs and caches bit for bit on
    both wires."""
    if graphs == "stand-in":
        monkeypatch.setattr(backend_mod, "StepGraphs", CPUGraphs)
    _, tcfg, _, tparams = _params("yi-9b")
    mb_size, n_b, n_s = 2, 3, 2
    pool, caches = _filled(tcfg, mb_size * n_b, 4)
    be = backend_mod.PipelinedBackend(
        tcfg, tparams, TRT, mb_size=mb_size, num_microbatches=n_b, pool=pool,
        device=CPU, n_stages=n_s, wire_dtype=wire, caches=caches)
    ref = _clone(caches)
    gen = torch.Generator()
    rng = np.random.RandomState(1)
    entries = [None] * n_s
    act = [None] * n_s
    got, want = [], []
    for t in range(8):
        active = t < 6
        mb = t % n_b
        tokens = rng.randint(1, tcfg.vocab_size, mb_size).astype(np.int32)
        pos = np.array([11 + t, 20 + t], np.int32)
        samp = _samp(rng, mb_size, t)
        got += [(r.mb, r.tokens, r.logprobs)
                for r in be.decode(mb, tokens, pos, samp, active=active)]
        entries = [(mb, pos, samp) if active else None] + entries[:-1]
        if not any(e is not None for e in entries):
            continue
        drained = entries[-1]
        dsamp = drained[2] if drained is not None else samp
        noise = gumbel_noise(dsamp, tcfg.vocab_size, CPU, gen)
        pos_stage = torch.from_numpy(np.stack(
            [e[1] if e is not None else np.zeros(mb_size, np.int32)
             for e in entries]))
        toks, lps, act = PL.pipeline_decode_tick(
            tparams, ref, act, torch.from_numpy(tokens), pos_stage,
            mb_assign=[e[0] if e is not None else -1 for e in entries],
            noise=noise, temp=torch.from_numpy(dsamp.temp),
            top_k=torch.from_numpy(dsamp.top_k),
            top_p=torch.from_numpy(dsamp.top_p), sampled=True, cfg=tcfg,
            rt=TRT, n_stages=n_s, mb_size=mb_size, wire_dtype=wire)
        if drained is not None:
            want.append((drained[0], toks.numpy(), lps.numpy()))
    assert len(got) == len(want) == 6
    for (gm, gt, gl), (wm, wt, wl) in zip(got, want):
        assert gm == wm
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
    _assert_caches_equal(be.caches, ref)
    if graphs == "stand-in":
        st = be.graphs.stats()
        assert st["replays_by_kind"] == {"stage": be.decode_stage_runs,
                                         "drain": be.epilogue_runs}
        assert st["captures"] == st["keys"] == n_s * n_b + n_b


# ------------------------------------------------------------ engine level

MAX_NEW = 6
LENGTHS = (40, 7, 30, 12, 33, 5)


def _serve_both(arch, jconf, tconf):
    jcfg, tcfg, jparams, tparams = _params(arch)
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, tcfg.vocab_size, n)) for n in LENGTHS]
    jl = jax_llm.LLM(jcfg, config=jconf, params=jparams, rt=JRT)
    tl = llm.LLM(tcfg, config=tconf, params=tparams, rt=TRT, device="cpu")
    want = jl.generate(prompts, JaxSP(temperature=0.0,
                                      max_new_tokens=MAX_NEW))
    got = tl.generate(prompts, SamplingParams(temperature=0.0,
                                              max_new_tokens=MAX_NEW))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.finished and w.finished
        assert g.token_ids == w.token_ids, f"request {i}"
    return tl


@pytest.mark.parametrize("arch", ["yi-9b", "recurrentgemma-9b"])
def test_stand_in_graphs_serve_repro_greedy_streams(arch, stand_in):
    """``LocalBackend`` at N_B = 2 (yi-9b with global pools swapped by the
    offloader) through stand-in graphs: the greedy streams equal
    ``repro``'s token for token, every decode tick is a replay, and each
    key is captured once (the prefill keys beside the two decode ones)."""
    kw = {}
    if arch == "yi-9b":
        kw = dict(page_size=8, n_local_pages=6, n_global_pages=12,
                  max_pages_per_seq=16)
    jconf = jax_llm.EngineConfig(mb_size=2, num_microbatches=2,
                                 pool=jkv.PoolConfig(**kw))
    tconf = llm.EngineConfig(mb_size=2, num_microbatches=2,
                             pool=tkv.PoolConfig(**kw))
    tl = _serve_both(arch, jconf, tconf)
    be = tl.engine.backend
    st = be.graphs.stats()
    assert st["decode_replays"] == be.decode_ticks > 0
    assert st["decode_captures"] == 2
    assert st["captures"] == st["keys"] == len(be.graph_entries())
    if arch == "yi-9b":
        assert be.swap_count > 0


def _strict_llm(tcfg, tparams, **kw):
    conf = llm.EngineConfig(mb_size=2, num_microbatches=2, strict=True,
                            pool=tkv.PoolConfig(page_size=8), **kw)
    return llm.LLM(tcfg, config=conf, params=tparams, rt=TRT, device="cpu")


def test_strict_auditor_refuses_a_second_capture(stand_in):
    """A serve captures each key once and the auditor passes; a key
    captured again mid-serve (its graph dropped, then run) fails the next
    audit."""
    _, tcfg, _, tparams = _params("yi-9b")
    tl = _strict_llm(tcfg, tparams)
    prompts = [[3, 4, 5, 6], [7, 8, 9], [10, 11, 12, 13, 14]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    tl.generate(prompts, sp)
    eng = tl.engine
    assert eng.auditor.checks > 0 and eng.backend.graph_entries()
    eng.backend.graphs._entries.clear()         # dropped mid-serve
    with pytest.raises(InvariantViolation, match="captured 2 times"):
        tl.generate(prompts, sp)


def test_a_reshard_captures_anew(stand_in):
    """A reshard builds a new backend with its own graphs: the auditor's
    pins start over, and the old backend's graphs are dropped."""
    _, tcfg, _, tparams = _params("yi-9b")
    tl = _strict_llm(tcfg, tparams, backend="pipelined", n_stages=2)
    eng = tl.engine
    old = eng.backend
    prompts = [[3, 4, 5, 6], [7, 8, 9], [10, 11, 12, 13, 14]]
    tl.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=3))
    assert old.graph_entries()
    eng.reshard(n_stages=1)
    assert not old.graph_entries() and eng.backend is not old
    tl.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=3))
    assert eng.backend.graph_entries()
    assert all(c == 1 for _, c in eng.backend.graph_entries().values())


# ------------------------------------------------------------ launch books

def test_replays_add_the_captured_launches():
    """The counters move only with replays: the warm-up's launches are
    booked apart and the capture's are kept by the graph, which adds them
    at each replay."""
    fn = PA.paged_decode_attention
    graphs = CPUGraphs()
    calls = []

    def step():
        calls.append(1)
        fn.launches += 3

    before = fn.launches
    for _ in range(4):
        graphs.run(("local", 0, False), CPU, step)
    assert fn.launches - before == 4 * 3
    assert graphs.warmup_launches["paged_attention"] == 3
    assert graphs.captures[("local", 0, False)] == 1
    assert graphs.replays[("local", 0, False)] == 4
    assert len(calls) == 2 + 4                  # warm-up, capture, replays


def test_eager_path_counts_every_launch():
    """Off the card the step is called as it is, counters untouched by the
    graph books."""
    fn = PA.paged_decode_attention
    graphs = step_graph.StepGraphs()
    before = fn.launches
    for _ in range(3):
        graphs.run("k", CPU, lambda: setattr(fn, "launches",
                                             fn.launches + 2))
    assert fn.launches - before == 6
    assert not graphs.entries() and not graphs.captures


def test_no_collection_while_a_step_is_captured(monkeypatch):
    """A collection during a capture could free another backend's dropped
    graph, and that call invalidates the capture: the cyclic collector is
    off while the step is recorded (capture_begin to capture_end) and on
    again after, also when the step raises.  The card's calls are faked
    here; the capture itself is the card's."""
    seen = []

    class Recorder:
        def capture_begin(self, **kw):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Recorder)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(step_graph, "_CAPTURE_STREAMS", {})
    graphs = step_graph.StepGraphs()
    assert gc.isenabled()
    graphs._new_graph(CPU, lambda: seen.append(("step", gc.isenabled())))
    assert seen == [("begin", False), ("step", False), ("end", False)]
    assert gc.isenabled()
    # every capture on a device records on the one stream made for it
    stream = step_graph._CAPTURE_STREAMS[CPU]
    graphs._new_graph(CPU, lambda: None)
    assert step_graph._CAPTURE_STREAMS == {CPU: stream}

    def fails():
        raise RuntimeError("a step that cannot be captured")
    with pytest.raises(RuntimeError, match="cannot be captured"):
        graphs._new_graph(CPU, fails)
    assert gc.isenabled()


def test_warmup_restores_the_recurrent_rows():
    """The warm-up and the capture each run the step on the stand-in;
    the state rows come back to their values before the first replay, so
    every tick steps the state once."""
    h = torch.zeros(4)
    graphs = CPUGraphs()
    for _ in range(3):
        graphs.run("k", CPU, lambda: h.add_(1.0), state=lambda: [h[1:3]])
    # rows 1..2 stepped once a run; rows 0 and 3 are not restored state
    assert h.tolist() == [5.0, 3.0, 3.0, 5.0]


# ------------------------------------------------------------ the workspace

@pytest.mark.parametrize("b,h,hk,dh,max_pages,page", [
    (16, 32, 4, 128, 128, 16), (4, 16, 8, 256, 64, 16), (8, 24, 8, 128, 8, 8),
    (4, 48, 3, 64, 300, 16), (1, 64, 4, 128, 2048, 32), (16, 8, 8, 64, 1, 8),
    (2, 96, 6, 128, 96, 16)])
@pytest.mark.parametrize("n_sm", [1, 78, 132])
def test_workspace_covers_every_launch_of_a_key(b, h, hk, dh, max_pages,
                                                page, n_sm):
    """``workspace_sizes`` covers each launch the wrapper makes for these
    shapes (one a launch of the group plan, G above 8 cut into launches of
    8), as ``_launch`` asks ``_scratch`` for it."""
    n_o, n_ml, pairs = PA.workspace_sizes(b, h, hk, dh, max_pages, page,
                                          n_sm)
    _, n_split = PA.split_plan(max_pages, page, b * hk, n_sm)
    for _, _, padded in groups.group_plan(h // hk, PA.GROUP_SIZES):
        h_launch = hk * padded
        assert b * h_launch * n_split * dh <= n_o
        assert b * h_launch * n_split * 2 <= n_ml
    assert pairs == b * hk


def test_a_pinned_workspace_never_grows():
    """Reserved and pinned, a launch within the reservation takes the same
    tensors and one needing more raises; unpinned, a growth puts new
    tensors in the device's slot and leaves the old ones (which a graph
    holds) as they were."""
    dev = torch.device("cpu")
    PA._workspace.pop(dev, None)
    shapes = dict(batch=4, heads=32, kv_heads=4, head_dim=128,
                  max_pages=64, page_size=16)
    held = PA.reserve_workspace(dev, n_sm=132, **shapes)
    n_o, n_ml, pairs = PA.workspace_sizes(4, 32, 4, 128, 64, 16, 132)
    assert tuple(t.numel() for t in held) == (n_o, n_ml, pairs)
    held[0].fill_(7.0)
    with PA.pinned(dev):
        same = PA._scratch(dev, n_o, n_ml, pairs)
        assert all(a is b for a, b in zip(same, held))
        with pytest.raises(RuntimeError, match="pinned"):
            PA._scratch(dev, n_o + 1, n_ml, pairs)
        with pytest.raises(RuntimeError, match="pinned"):
            PA.reserve_workspace(dev, n_sm=132, **dict(shapes, batch=8))
    grown = PA._scratch(dev, 2 * n_o, n_ml, pairs)
    assert grown[0] is not held[0] and grown[1] is held[1]
    assert torch.all(held[0] == 7.0)
    assert PA.workspace(dev)[0] is grown[0]
    PA._workspace.pop(dev, None)


def test_backends_reserve_for_their_geometry(monkeypatch):
    """Before its first capture on a device a backend reserves the paged
    workspace for its microbatch over the table's width; an arch with no
    paged layer, and the CPU, reserve nothing."""
    seen = []
    monkeypatch.setattr(backend_mod.paged_lib, "reserve_workspace",
                        lambda dev, **kw: seen.append((dev, kw)))
    for arch, want in (("yi-9b", 1), ("recurrentgemma-9b", 0)):
        seen.clear()
        _, tcfg, _, tparams = _params(arch)
        pool = tkv.PoolConfig(page_size=8, max_pages_per_seq=16)
        be = backend_mod.LocalBackend(tcfg, tparams, TRT, mb_size=2,
                                      num_microbatches=2, pool=pool,
                                      device=CPU)
        be._reserve_workspace(CPU)
        assert not seen
        be._reserve_workspace(torch.device("cuda", 0))
        assert len(seen) == want
        if want:
            assert seen[0][1] == dict(
                batch=2, heads=tcfg.num_heads, kv_heads=tcfg.num_kv_heads,
                head_dim=tcfg.head_dim, max_pages=16, page_size=8)


def test_state_rows_lists_only_recurrent_state():
    """Pools and rings are written by position and are left out; every
    recurrent leaf's rows are views into the caches."""
    _, tcfg, _, _ = _params("recurrentgemma-9b")
    caches = tkv.build_paged_caches(tcfg, 4, tkv.PoolConfig(page_size=8),
                                    TRT, "cpu")
    rows = tkv.state_rows(caches, 2, 2)
    kinds = tcfg.layer_kinds()
    assert len(rows) == 2 * sum(k == "rglru" for k in kinds)
    for r in rows:
        assert r.shape[0] == 2 and r._is_view()
    assert tkv.state_rows(caches, 0, 4, (len(kinds), len(kinds))) == []
