"""DeServe's §4.3 pipeline in the port (``repro_torch.core.pipeline``, the
``PipelinedBackend`` and the engine around it) against the JAX package,
float32 on the CPU.

The JAX pipeline runs its stages inside one ``shard_map`` over a ``pod``
mesh, which needs one host device a stage: its side runs in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``
(as ``tests/test_backend.py`` runs it), shared by every case of this file,
and writes an ``.npz`` that the cases read (about a minute of one core:
four tick compiles and three pipelined engines).  Both packages use the weights
of ``repro.models.model.init_params`` (``PRNGKey(0)``), carried across with
``from_jax_params``.

- Tick parity: one ``pipeline_decode_tick`` and one
  ``pipeline_prefill_chunk_tick`` of both packages on the same seeded
  pools, page tables and activations, both wire dtypes, with every stage
  occupied and with a bubble: drained tokens, log-probs and logits, the
  new activations of the occupied stages and every pool within 1e-5.
- Engine parity: greedy streams of the pipelined engines equal token for
  token at N_S = 2, N_B = 3, offload on (microbatches 0 and 2 contend for
  global parity 0), on reduced yi-9b (chunked prefill, one leftover
  period in the epilogue), gemma3-12b (exact prefill, rings, a two-layer
  tail) and recurrentgemma-9b (an epilogue of two rglru layers; each
  request gets a fresh slot, because the reference leaks recurrent state
  into reassigned slots, ROADMAP Queue 3).
- The port against itself: pipelined streams (sampled ones too) equal the
  local backend's, ``round_flush`` equals ``circular``, and the refusals.
"""

import json
import os
import subprocess
import sys

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
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.backend import PipelinedBackend  # noqa: E402
from repro_torch.serving.request import SamplingParams  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
TOL = 1e-5

# the tick cases: reduced yi-9b with 3 layers (one period a stage, one
# leftover period in the epilogue), 2 stages, 3 microbatches of 2 rows
SETUP = dict(arch="yi-9b", layers=3, n_stages=2, mb_size=2, n_mb=3,
             page_size=4, n_pages=40, max_pages=6, rows=2, chunk=4, seed=3)
# decode: microbatch per stage (-1 a bubble); prefill: occupied stages
DECODE_CASES = {"full": [2, 0], "filling": [1, -1], "draining": [-1, 2]}
PREFILL_CASES = {"full": [1, 1], "filling": [1, 0], "draining": [0, 1]}
WIRES = ("fp32", "int8")
# the engine cases: JAX's contended-parity case (tests/test_backend.py)
ENGINE_ARCHS = {"yi-9b": 10, "gemma3-12b": 10, "recurrentgemma-9b": 6}
ENGINE_POOL = dict(page_size=4, n_local_pages=32, n_global_pages=12,
                   max_pages_per_seq=6)
ENGINE_NEW = 6

JAX_SIDE = r"""
import json, os, sys
# one host device a stage; one thread each, as the suite runs files on
# several workers at once
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import functools
import numpy as np
import jax, jax.numpy as jnp
from repro.config import get_arch, reduced_config
from repro.core import pipeline as PL
from repro.models import model as M
from repro.models.common import Runtime
from repro.serving import kv_cache as kvc
from repro.serving.llm import LLM, EngineConfig
from repro.serving.request import SamplingParams

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
S = spec["setup"]
rt = Runtime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
out = {}


def layer_pools(caches):
    # port layer order: period by period, then the tail
    res = []
    n = caches["scan"][0]["k_pages"].shape[0] if caches["scan"] else 0
    for p in range(n):
        for c in caches["scan"]:
            res.append((np.asarray(c["k_pages"][p]),
                        np.asarray(c["v_pages"][p])))
    for c in caches["tail"]:
        res.append((np.asarray(c["k_pages"]), np.asarray(c["v_pages"])))
    return res


def save_pools(prefix, caches):
    for i, (k, v) in enumerate(layer_pools(caches)):
        out[f"{prefix}/L{i}/k"] = k
        out[f"{prefix}/L{i}/v"] = v


# ---- ticks ----
cfg = reduced_config(get_arch(S["arch"]), num_layers=S["layers"])
params = M.init_params(cfg, jax.random.PRNGKey(0), rt)
NS, MB, NB = S["n_stages"], S["mb_size"], S["n_mb"]
B, P, PG = MB * NB, S["max_pages"], S["page_size"]
R, C, D = S["rows"], S["chunk"], cfg.d_model
pool = kvc.PoolConfig(page_size=PG, n_local_pages=S["n_pages"],
                      n_global_pages=0, max_pages_per_seq=P)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:NS]), ("pod",))
rng = np.random.RandomState(S["seed"])


def seeded_caches():
    caches = kvc.build_paged_caches(cfg, B, pool, rt)
    scan = []
    for c in caches["scan"]:
        c = dict(c)
        for name in ("k_pages", "v_pages"):
            c[name] = jnp.asarray(rng.standard_normal(
                c[name].shape).astype(np.float32))
        scan.append(c)
    caches = {"scan": scan, "tail": caches["tail"]}
    table = (1 + rng.permutation(S["n_pages"] - 1)[:B * P]).reshape(B, P)
    return kvc.set_page_table(caches, table.astype(np.int32)), table


for wire in spec["wires"]:
    tick = jax.jit(functools.partial(
        PL.pipeline_decode_tick, cfg=cfg, rt=rt, n_stages=NS, mb_size=MB,
        mesh=mesh, wire_dtype=wire))
    for case, assign in spec["decode"].items():
        key = f"decode/{wire}/{case}"
        caches, table = seeded_caches()
        act = rng.standard_normal((NS, MB, 1, D)).astype(np.float32)
        tokens = rng.randint(1, cfg.vocab_size, (MB,)).astype(np.int32)
        pos = rng.randint(1, P * PG - 1, (NS, MB)).astype(np.int32)
        out[f"{key}/table"] = table
        out[f"{key}/act"] = act
        out[f"{key}/tokens"] = tokens
        out[f"{key}/pos"] = pos
        save_pools(f"{key}/in", caches)
        z = np.zeros((MB,), np.int32)
        toks, lps, new, new_act = tick(
            params, caches, jnp.asarray(act), jnp.asarray(tokens),
            jnp.asarray(np.asarray(assign, np.int32)), jnp.asarray(pos),
            jnp.zeros((MB, 2), jnp.uint32), jnp.asarray(z),
            jnp.zeros((MB,), jnp.float32), jnp.asarray(z),
            jnp.ones((MB,), jnp.float32), jnp.int32(-1))
        out[f"{key}/toks"] = np.asarray(toks)
        out[f"{key}/lps"] = np.asarray(lps)
        out[f"{key}/new_act"] = np.asarray(new_act)
        save_pools(f"{key}/out", new)
    tick = jax.jit(functools.partial(
        PL.pipeline_prefill_chunk_tick, cfg=cfg, rt=rt, n_stages=NS,
        mesh=mesh, wire_dtype=wire))
    for case, occ in spec["prefill"].items():
        key = f"prefill/{wire}/{case}"
        caches, table = seeded_caches()
        act = rng.standard_normal((NS, R, C, D)).astype(np.float32)
        tokens = rng.randint(1, cfg.vocab_size, (R, C)).astype(np.int32)
        offs = rng.randint(0, (P - 1) * PG, (NS, R)).astype(np.int32)
        nval = rng.randint(1, C + 1, (NS, R)).astype(np.int32)
        nval[:, -1] = np.minimum(nval[:, -1], 2)    # a short row
        nval *= np.asarray(occ, np.int32)[:, None]  # bubble: no writes
        tabs = np.stack([table[rng.permutation(B)[:R]] for _ in range(NS)])
        tabs *= np.asarray(occ, np.int32)[:, None, None]
        lasts = (nval[-1] - 1).clip(0).astype(np.int32)
        for name, a in (("act", act), ("tokens", tokens), ("offs", offs),
                        ("nval", nval), ("tabs", tabs), ("lasts", lasts),
                        ("table", table)):
            out[f"{key}/{name}"] = a
        save_pools(f"{key}/in", caches)
        logits, new, new_act = tick(
            params, caches, jnp.asarray(act), jnp.asarray(tokens),
            jnp.asarray(offs), jnp.asarray(nval), jnp.asarray(tabs),
            jnp.asarray(lasts), jnp.int32(-1))
        out[f"{key}/logits"] = np.asarray(logits)
        out[f"{key}/new_act"] = np.asarray(new_act)
        save_pools(f"{key}/out", new)

# ---- engines ----
for arch, n_req in spec["engines"].items():
    cfg0 = get_arch(arch)
    period = len(cfg0.block_pattern)
    ecfg = reduced_config(cfg0, num_layers=2 * period + (2 if period > 1
                                                         else 1))
    eparams = M.init_params(ecfg, jax.random.PRNGKey(0), rt)
    prng = np.random.RandomState(7)
    prompts = [list(prng.randint(1, ecfg.vocab_size, prng.randint(3, 10)))
               for _ in range(n_req)]
    llm = LLM(ecfg, params=eparams, rt=rt, config=EngineConfig(
        backend="pipelined", n_stages=2, mb_size=2, num_microbatches=3,
        pool=kvc.PoolConfig(**spec["pool"]), offload=True))
    outs = llm.generate(prompts, SamplingParams(
        temperature=0.0, max_new_tokens=spec["new"]), max_steps=800)
    assert all(o.finished for o in outs)
    out[f"engine/{arch}/streams"] = np.asarray(
        [o.token_ids + [-1] * (spec["new"] - len(o.token_ids))
         for o in outs], np.int64)
    out[f"engine/{arch}/prompts"] = np.asarray(
        [p + [0] * (16 - len(p)) for p in prompts], np.int64)
    out[f"engine/{arch}/prompt_lens"] = np.asarray([len(p) for p in prompts])
    out[f"engine/{arch}/swaps"] = np.asarray(llm.engine.backend.swap_count)
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's ticks and pipelined engines, run once in a
    subprocess with two host devices."""
    path = str(tmp_path_factory.mktemp("jax_pipeline") / "jax.npz")
    spec = dict(setup=SETUP, wires=list(WIRES), decode=DECODE_CASES,
                prefill=PREFILL_CASES, engines=ENGINE_ARCHS,
                pool=ENGINE_POOL, new=ENGINE_NEW)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, path,
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(path))


def _port_setup(arch, num_layers):
    jcfg = jax_reduced(jax_get_arch(arch), num_layers=num_layers)
    tcfg = reduced_config(get_arch(arch), num_layers=num_layers)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    return tcfg, from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                 TRT, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seeded_port_caches(tcfg, out, key):
    S = SETUP
    pool = tkv.PoolConfig(page_size=S["page_size"],
                          n_local_pages=S["n_pages"], n_global_pages=0,
                          max_pages_per_seq=S["max_pages"])
    caches = tkv.build_paged_caches(tcfg, S["mb_size"] * S["n_mb"], pool,
                                    TRT, "cpu")
    for i, layer in enumerate(caches["layers"]):
        layer["k_pages"].copy_(_t(out[f"{key}/in/L{i}/k"]))
        layer["v_pages"].copy_(_t(out[f"{key}/in/L{i}/v"]))
    return tkv.set_page_table(caches, out[f"{key}/table"])


def _assert_pools(caches, out, key):
    for i, layer in enumerate(caches["layers"]):
        for name, short in (("k_pages", "k"), ("v_pages", "v")):
            np.testing.assert_allclose(
                layer[name].numpy(), out[f"{key}/out/L{i}/{short}"],
                atol=TOL, rtol=TOL, err_msg=f"{key} layer {i} {name}")


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_tick_matches_jax(jax_side, case, wire):
    out, key = jax_side, f"decode/{wire}/{case}"
    S = SETUP
    tcfg, tparams = _port_setup(S["arch"], S["layers"])
    caches = _seeded_port_caches(tcfg, out, key)
    assign = DECODE_CASES[case]
    act = [_t(a) for a in out[f"{key}/act"]]
    mb = S["mb_size"]
    toks, lps, new_act = PL.pipeline_decode_tick(
        tparams, caches, act, _t(out[f"{key}/tokens"]),
        _t(out[f"{key}/pos"]), mb_assign=assign, noise=None,
        temp=torch.zeros(mb), top_k=torch.zeros(mb, dtype=torch.int32),
        top_p=torch.ones(mb), sampled=False, cfg=tcfg, rt=TRT,
        n_stages=S["n_stages"], mb_size=mb, wire_dtype=wire)
    _assert_pools(caches, out, key)
    if assign[-1] >= 0:
        np.testing.assert_array_equal(toks.numpy(), out[f"{key}/toks"])
        np.testing.assert_allclose(lps.numpy(), out[f"{key}/lps"],
                                   atol=TOL, rtol=TOL)
    else:
        assert toks is None and lps is None
    # the activation each occupied stage passed on (JAX also permutes the
    # last stage's output around to stage 0, whose input is the embedding)
    for s in range(S["n_stages"] - 1):
        if assign[s] >= 0:
            np.testing.assert_allclose(new_act[s + 1].numpy(),
                                       out[f"{key}/new_act"][s + 1],
                                       atol=TOL, rtol=TOL)
        else:
            assert new_act[s + 1] is None


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_chunk_tick_matches_jax(jax_side, case, wire):
    out, key = jax_side, f"prefill/{wire}/{case}"
    S = SETUP
    tcfg, tparams = _port_setup(S["arch"], S["layers"])
    caches = _seeded_port_caches(tcfg, out, key)
    occ = [bool(o) for o in PREFILL_CASES[case]]
    act = [_t(a) for a in out[f"{key}/act"]]
    logits, new_act = PL.pipeline_prefill_chunk_tick(
        tparams, caches, act, *[_t(out[f"{key}/{n}"]) for n in
                                ("tokens", "offs", "nval", "tabs", "lasts")],
        occupied=occ, cfg=tcfg, rt=TRT, n_stages=S["n_stages"],
        wire_dtype=wire)
    _assert_pools(caches, out, key)
    if occ[-1]:
        np.testing.assert_allclose(logits.numpy(), out[f"{key}/logits"],
                                   atol=TOL, rtol=TOL)
    else:
        assert logits is None
    for s in range(S["n_stages"] - 1):
        if occ[s]:
            np.testing.assert_allclose(new_act[s + 1].numpy(),
                                       out[f"{key}/new_act"][s + 1],
                                       atol=TOL, rtol=TOL)


def _engine_case(jax_side, arch):
    """The JAX engine case's config, params and prompts, for the port."""
    cfg0 = get_arch(arch)
    period = len(cfg0.block_pattern)
    tcfg, tparams = _port_setup(arch, 2 * period + (2 if period > 1 else 1))
    lens = jax_side[f"engine/{arch}/prompt_lens"]
    prompts = [list(map(int, row[:n])) for row, n in
               zip(jax_side[f"engine/{arch}/prompts"], lens)]
    return tcfg, tparams, prompts


def _pipe_config(**kw):
    base = dict(backend="pipelined", n_stages=2, mb_size=2,
                num_microbatches=3, pool=tkv.PoolConfig(**ENGINE_POOL))
    base.update(kw)
    return llm.EngineConfig(**base)


@pytest.mark.parametrize("arch", list(ENGINE_ARCHS))
def test_pipelined_engine_matches_jax(jax_side, arch):
    tcfg, tparams, prompts = _engine_case(jax_side, arch)
    tl = llm.LLM(tcfg, config=_pipe_config(), params=tparams, rt=TRT,
                 device="cpu")
    outs = tl.generate(prompts, SamplingParams(temperature=0.0,
                                               max_new_tokens=ENGINE_NEW))
    want = jax_side[f"engine/{arch}/streams"]
    for i, o in enumerate(outs):
        assert o.finished
        assert o.token_ids == [int(t) for t in want[i] if t >= 0], \
            f"{arch} request {i}"
    be = tl.engine.backend
    assert isinstance(be, PipelinedBackend)
    assert tl.engine.chunked_prefill == (arch == "yi-9b")
    assert be.swap_count == int(jax_side[f"engine/{arch}/swaps"]) > 0
    assert not be.pending() and not be.prefill_pending()


@pytest.mark.parametrize("arch", list(ENGINE_ARCHS))
def test_pipelined_streams_equal_local_streams(jax_side, arch):
    """Greedy and sampled requests side by side: the pipe drains each
    microbatch N_S - 1 ticks later, and admission waits for busy
    microbatches, but every stream is the local backend's."""
    tcfg, tparams, prompts = _engine_case(jax_side, arch)
    sps = [SamplingParams(temperature=0.0 if i % 2 == 0 else 0.9,
                          top_k=8 if i % 4 == 1 else 0,
                          max_new_tokens=ENGINE_NEW, logprobs=True)
           for i in range(len(prompts))]
    runs = {}
    for label, conf in (("local", _pipe_config(backend="local",
                                               n_stages=2)),
                        ("pipelined", _pipe_config())):
        tl = llm.LLM(tcfg, config=conf, params=tparams, rt=TRT,
                     device="cpu")
        runs[label] = tl.generate(prompts, sps)
    for a, b in zip(runs["local"], runs["pipelined"]):
        assert a.token_ids == b.token_ids
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=TOL)
    assert runs["local"][1].token_ids != runs["local"][0].token_ids


def test_round_flush_streams_equal_circular_streams(jax_side):
    """The vLLM-PP baseline drains the pipe every token round: more ticks,
    the same tokens.  On a virtual clock with a fixed 16 ms stage time and
    64 ms links (the JAX latency curve's), circular at N_B = 4 against
    round_flush at N_B = N_S = 2 books the §4.3 gain: a round takes
    2 T_S + 2 L for 4 microbatches instead of 2."""
    from repro_torch.distributed.transport import SimulatedLinkTransport
    tcfg, tparams, prompts = _engine_case(jax_side, "yi-9b")
    sp = SamplingParams(temperature=0.0, max_new_tokens=ENGINE_NEW)
    runs, reps = {}, {}
    for schedule, n_b in (("circular", 4), ("round_flush", 4),
                          ("round_flush", 2)):
        tr = SimulatedLinkTransport.uniform(2, 0.064, stage_time_s=0.016)
        tl = llm.LLM(tcfg, config=_pipe_config(
            schedule=schedule, transport=tr, num_microbatches=n_b),
            params=tparams, rt=TRT, device="cpu")
        runs[schedule, n_b] = [o.token_ids for o in tl.generate(prompts, sp)]
        reps[schedule, n_b] = tl.stats()
    assert runs["circular", 4] == runs["round_flush", 4] == \
        runs["round_flush", 2]
    assert reps["round_flush", 4]["decode_ticks"] > \
        reps["circular", 4]["decode_ticks"]
    assert reps["circular", 4]["virtual_decode_tok_per_s"] > 1.5 * \
        reps["round_flush", 2]["virtual_decode_tok_per_s"]


def test_fewer_microbatches_than_stages_is_refused():
    tcfg, tparams = _port_setup("yi-9b", 3)
    with pytest.raises(ValueError, match="N_B >= N_S"):
        llm.EngineConfig(backend="pipelined", n_stages=2,
                         num_microbatches=1)
    with pytest.raises(ValueError, match="N_B >= N_S"):
        PipelinedBackend(tcfg, tparams, TRT, mb_size=2, num_microbatches=1,
                         pool=tkv.PoolConfig(), device=torch.device("cpu"),
                         n_stages=2)


@pytest.mark.parametrize("mesh", [
    [torch.device("cpu"), torch.device("cuda:0")],
    [torch.device("cuda:0"), torch.device("cuda:1")],
])
def test_stages_on_two_devices_are_refused(mesh):
    with pytest.raises(NotImplementedError, match="stages on several GPUs"):
        llm.EngineConfig(backend="pipelined", n_stages=2,
                         num_microbatches=2, mesh=mesh)


def test_a_one_device_mesh_serves():
    tcfg, tparams = _port_setup("yi-9b", 3)
    conf = llm.EngineConfig(backend="pipelined", n_stages=2, mb_size=2,
                            num_microbatches=2,
                            mesh=[torch.device("cpu")] * 2)
    tl = llm.LLM(tcfg, config=conf, params=tparams, rt=TRT, device="cpu")
    assert tl.engine.backend.stage_devices == [torch.device("cpu")] * 2
    outs = tl.generate([[1, 2, 3], [4, 5]],
                       SamplingParams(temperature=0.0, max_new_tokens=3))
    assert all(o.finished and len(o.token_ids) == 3 for o in outs)
