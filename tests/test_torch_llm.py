"""``repro_torch.serving.llm.LLM`` end to end against ``repro.serving.llm.LLM``.

Both front ends serve the same prompts on the same weights (the JAX
package's ``init_params``, carried across with ``from_jax_params``), in
float32 on the CPU, through the same prefill schedule: chunked for the
fully-paged yi-9b and the MoE and dense archs of the other-architectures
slice, exact-length for the sliding-window gemma3 and the recurrent
recurrentgemma and xlstm (and for yi-9b under ``prefill_mode="exact"``).  Greedy
streams must be identical token for token.  Sampled streams cannot be
compared across the two (``jax.random`` and ``torch.Generator`` draw
different noise), so they are checked for shape here and for layout
invariance inside the port.
"""

import dataclasses
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
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving.kv_cache import PoolConfig as JaxPool  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.kv_cache import PoolConfig  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
VARIANTS = {"reduced": {},
            "hd64": dict(num_heads=8, num_kv_heads=2, head_dim=64)}
POOL = dict(page_size=8, n_local_pages=64, max_pages_per_seq=16)
MAX_NEW = 8
# prompt lengths around and past the 32-token default chunk
LENGTHS = (40, 7, 70, 12, 33, 5)
# (temperature, top_k, top_p) per request; even requests greedy
POLICIES = [(0.0, 0, 1.0), (0.8, 0, 1.0), (0.0, 0, 1.0), (1.0, 20, 1.0),
            (0.0, 0, 1.0), (0.9, 0, 0.9)]


def setup(variant, arch="yi-9b"):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw)
    tcfg = dataclasses.replace(reduced_config(get_arch(arch)), **kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, tcfg.vocab_size, n)) for n in LENGTHS]
    return jcfg, tcfg, jparams, tparams, prompts


def port_llm(tcfg, tparams, mb, n_mb, prefill_mode="auto"):
    cfg = llm.EngineConfig(mb_size=mb, num_microbatches=n_mb,
                           pool=PoolConfig(**POOL),
                           prefill_mode=prefill_mode)
    return llm.LLM(tcfg, config=cfg, params=tparams, rt=TRT, device="cpu")


def sampling(cls, mixed):
    return [cls(temperature=t if mixed else 0.0, top_k=k if mixed else 0,
                top_p=p if mixed else 1.0, max_new_tokens=MAX_NEW)
            for t, k, p in POLICIES]


def jax_streams(jcfg, jparams, prompts, sps, mb, n_mb, mode="auto"):
    jax_cfg = jax_llm.EngineConfig(mb_size=mb, num_microbatches=n_mb,
                                   pool=JaxPool(**POOL), prefill_mode=mode)
    return jax_llm.LLM(jcfg, config=jax_cfg, params=jparams, rt=JRT
                       ).generate(prompts, sps)


def assert_streams_match_jax(arch, variant, mb, n_mb, mixed, mode="auto"):
    """The port at ``mb x n_mb`` slots against the JAX package.  For an
    arch with recurrent layers the JAX side gets a slot a request: its
    ``reset_slot`` leaves a reassigned slot's recurrent state as the last
    request left it (ROADMAP Queue 3), where the port clears it, so only
    fresh JAX slots are a reference (``test_reference_leaks_recurrent_
    state_into_reassigned_slots``)."""
    jcfg, tcfg, jparams, tparams, prompts = setup(variant, arch)
    if tcfg.recurrent_layer_count():
        jmb, jn_mb = len(prompts), 1
    else:
        jmb, jn_mb = mb, n_mb
    want = jax_streams(jcfg, jparams, prompts, sampling(JaxSP, mixed), jmb,
                       jn_mb, mode)
    port = port_llm(tcfg, tparams, mb, n_mb, mode)
    fully_paged = all(k in ("attn", "global") for k in tcfg.layer_kinds())
    assert port.engine.chunked_prefill == (fully_paged and mode != "exact")
    got = port.generate(prompts, sampling(SamplingParams, mixed))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.finished and w.finished
        assert len(g.token_ids) == len(w.token_ids) == MAX_NEW
        assert all(0 <= t < tcfg.vocab_size for t in g.token_ids)
        if sampling(SamplingParams, mixed)[i].temperature <= 0:
            assert g.token_ids == w.token_ids, f"request {i}"


@pytest.mark.parametrize("variant,mb,n_mb,mixed", [
    ("reduced", 2, 1, False),
    ("reduced", 2, 1, True),
    ("reduced", 2, 2, True),
    ("hd64", 2, 1, True),
    ("hd64", 2, 2, True),
])
def test_greedy_streams_match_jax(variant, mb, n_mb, mixed):
    assert_streams_match_jax("yi-9b", variant, mb, n_mb, mixed)


# Reduced gemma3 and recurrentgemma (window 32; prompts of 33-70 tokens
# run past it) take the exact-length path under "auto"; yi-9b takes it
# under "exact".  Six requests over two or four slots: slots are
# reassigned, so reset_slot must clear rings and recurrent states.
@pytest.mark.parametrize("arch,mb,n_mb,mode", [
    ("gemma3-1b", 2, 1, "auto"),
    ("gemma3-1b", 2, 2, "auto"),
    ("yi-9b", 2, 2, "exact"),
    ("recurrentgemma-9b", 2, 1, "auto"),
    ("recurrentgemma-9b", 2, 2, "auto"),
])
def test_exact_prefill_greedy_streams_match_jax(arch, mb, n_mb, mode):
    assert_streams_match_jax(arch, "reduced", mb, n_mb, True, mode)


# The archs of the other-architectures slice, reduced: the MoE archs and
# the dense llama3-70b / minitron-4b take chunked prefill (every row of a
# chunk or a decode tick, padding and free slots included, takes expert
# capacity, so the JAX side runs the same batch layout); xlstm takes the
# exact path with power-of-two buckets, and its slots are reassigned on
# the port's side, so reset_slot must clear the mLSTM and sLSTM states.
@pytest.mark.parametrize("arch,mb,n_mb,mode", [
    ("phi3.5-moe-42b-a6.6b", 2, 1, "auto"),
    ("phi3.5-moe-42b-a6.6b", 2, 2, "auto"),
    ("qwen3-moe-235b-a22b", 2, 2, "auto"),
    ("qwen3-moe-235b-a22b", 3, 1, "exact"),
    ("minitron-4b", 2, 2, "auto"),
    ("llama3-70b", 2, 1, "auto"),
    ("xlstm-1.3b", 2, 1, "auto"),
    ("xlstm-1.3b", 2, 2, "auto"),
])
def test_other_archs_greedy_streams_match_jax(arch, mb, n_mb, mode):
    assert_streams_match_jax(arch, "reduced", mb, n_mb, True, mode)


def test_reassigned_xlstm_slot_streams_equal_a_fresh_engine():
    """Through one slot, each request of reduced xlstm-1.3b starts from
    the zero mLSTM and sLSTM states that ``reset_slot`` restores: its
    greedy stream equals the one it gets alone in a fresh engine."""
    _, tcfg, _, tparams, prompts = setup("reduced", "xlstm-1.3b")
    sps = sampling(SamplingParams, False)[:3]
    shared = port_llm(tcfg, tparams, 1, 1).generate(prompts[:3], sps)
    for p, sp, out in zip(prompts[:3], sps, shared):
        alone = port_llm(tcfg, tparams, 1, 1).generate([p], [sp])[0]
        assert out.token_ids == alone.token_ids


@pytest.mark.parametrize("knob", ["plan", "fault_plan"])
def test_xlstm_refusals_match_jax(knob):
    """Both packages refuse to plan KV pools for a pure-recurrent arch,
    and to inject faults into one (a lost tick would step its recurrent
    states twice when injected again), with the same message."""
    from repro.distributed.elastic import FaultPlan as JaxFaultPlan
    from repro_torch.distributed.elastic import FaultPlan
    jcfg, tcfg, jparams, tparams, _ = setup("reduced", "xlstm-1.3b")
    if knob == "plan":
        kw = dict(n_stages=1, stage_time=0.1, latency=0.0, m_kv_bytes=1e6)
        jconf = jax_llm.EngineConfig.plan(**kw)
        tconf = llm.EngineConfig.plan(**kw)
        match = "pure-recurrent"
    else:
        kw = dict(backend="pipelined", n_stages=1, num_microbatches=2,
                  pool=None)
        jconf = jax_llm.EngineConfig(
            **kw, fault_plan=JaxFaultPlan.parse(["drop@decode:1:0"]))
        tconf = llm.EngineConfig(
            **kw, fault_plan=FaultPlan.parse(["drop@decode:1:0"]))
        match = "recurrent layers accumulate state"
    with pytest.raises(ValueError, match=match):
        jax_llm.LLM(jcfg, config=jconf, params=jparams, rt=JRT)
    with pytest.raises(ValueError, match=match):
        llm.LLM(tcfg, config=tconf, params=tparams, rt=TRT, device="cpu")


def test_exact_prefill_streams_equal_chunked_streams():
    """Both admission paths of the port give yi-9b the same greedy streams
    (the chunked path's attention is the exact path's, cut into chunks)."""
    _, tcfg, _, tparams, prompts = setup("reduced")
    sps = sampling(SamplingParams, False)
    exact = port_llm(tcfg, tparams, 2, 2, "exact").generate(prompts, sps)
    chunked = port_llm(tcfg, tparams, 2, 2, "chunked").generate(prompts, sps)
    assert [o.token_ids for o in exact] == [o.token_ids for o in chunked]


def test_chunked_prefill_of_a_sliding_window_arch_raises():
    """As in the JAX engine: rings cannot take chunked prefill."""
    _, tcfg, _, tparams, _ = setup("reduced", "gemma3-1b")
    with pytest.raises(ValueError, match="exact-length"):
        port_llm(tcfg, tparams, 2, 1, "chunked")
    with pytest.raises(ValueError, match="prefill_mode"):
        llm.EngineConfig(prefill_mode="bucketed")


def test_reference_leaks_recurrent_state_into_reassigned_slots():
    """``repro.serving.kv_cache.reset_slot`` clears only the layers that
    have ``"pos"`` or ``"k_pages"`` (``_map_paged_leaves``), so a
    reassigned slot's prefill starts from the recurrent state the slot's
    last request (or its idle decode ticks) left behind, and a request's
    greedy stream depends on where it was scheduled.  The port's
    ``reset_slot`` zeros ``h`` and ``conv``: its streams do not depend on
    the number of slots, and equal the JAX package's when every JAX
    request has a fresh slot."""
    assert_reference_leaks_recurrent_state("recurrentgemma-9b")


def test_reference_leaks_xlstm_state_into_reassigned_slots():
    """The same defect on xlstm: the reference's ``reset_slot`` leaves
    every mLSTM ``c, n, m`` and sLSTM ``c, n, h, m`` as the slot's last
    request left them; the port restores the zero states."""
    assert_reference_leaks_recurrent_state("xlstm-1.3b")


def assert_reference_leaks_recurrent_state(arch):
    jcfg, tcfg, jparams, tparams, prompts = setup("reduced", arch)
    sps = sampling(SamplingParams, False)
    fresh = [o.token_ids for o in jax_streams(
        jcfg, jparams, prompts, sampling(JaxSP, False), len(prompts), 1)]
    reused = [o.token_ids for o in jax_streams(
        jcfg, jparams, prompts, sampling(JaxSP, False), 2, 1)]
    # requests 0 and 1 take fresh slots in both JAX runs; later ones
    # inherit a state in the second
    assert reused[:2] == fresh[:2] and reused != fresh
    port_few = port_llm(tcfg, tparams, 2, 1).generate(prompts, sps)
    port_many = port_llm(tcfg, tparams, len(prompts), 1).generate(prompts,
                                                                  sps)
    assert [o.token_ids for o in port_few] == \
        [o.token_ids for o in port_many] == fresh


def test_recurrent_archs_bucket_prompts_to_powers_of_two():
    """As ``repro.serving.engine.OfflineEngine._prefill_len``: the next
    power of two (at least 8) with recurrent layers, else a multiple of
    8; and chunked prefill of a recurrent arch raises."""
    _, tcfg, _, tparams, _ = setup("reduced", "recurrentgemma-9b")
    engine = port_llm(tcfg, tparams, 2, 1).engine
    assert not engine.chunked_prefill
    assert [engine._prefill_len(n) for n in (1, 9, 16, 17, 40)] == \
        [8, 16, 16, 32, 64]
    _, ycfg, _, yparams, _ = setup("reduced")
    assert port_llm(ycfg, yparams, 2, 1).engine._prefill_len(17) == 24
    with pytest.raises(ValueError, match="exact-length"):
        port_llm(tcfg, tparams, 2, 1, "chunked")


def test_padded_ring_loss_at_power_of_two_buckets_matches_jax():
    """The reference's padded-ring defect (ROADMAP Queue 3) at the
    recurrent archs' buckets: a 40-token prompt pads to 64, the 32-slot
    ring keeps the last 32 slots of the *padded* sequence, so it holds
    positions 32..39 only and 24 in-window tokens (64 - 40) are lost.
    Both engines, after the same admission step (prefill, then one decode
    tick that writes position 40)."""
    jcfg, tcfg, jparams, tparams, prompts = setup("reduced",
                                                  "recurrentgemma-9b")
    prompt = prompts[0]
    assert len(prompt) == 40
    jax_cfg = jax_llm.EngineConfig(mb_size=1, num_microbatches=1,
                                   pool=JaxPool(**POOL))
    jeng = jax_llm.LLM(jcfg, config=jax_cfg, params=jparams, rt=JRT).engine
    teng = port_llm(tcfg, tparams, 1, 1).engine
    jeng.submit([JaxRequest(0, prompt, JaxSP(max_new_tokens=4))])
    teng.submit([Request(0, prompt, SamplingParams(max_new_tokens=4))])
    jeng.step()
    teng.step()
    # the local layer is the third of the first period: scan leaf 2,
    # period 0 in the JAX tree, layer 2 in the port's list
    local = tcfg.layer_kinds().index("local")
    jring = np.asarray(jeng.backend.caches["scan"][local]["pos"][0, 0])
    tring = teng.backend.caches["layers"][local]["pos"][0].numpy()
    want = np.full(32, -1)
    want[:9] = np.arange(32, 41)
    np.testing.assert_array_equal(jring, want)
    np.testing.assert_array_equal(tring, want)
    assert teng._prefill_len(40) - 40 == 24


def test_sampled_stream_does_not_depend_on_batch_layout():
    _, tcfg, _, tparams, prompts = setup("reduced")
    sps = sampling(SamplingParams, True)
    a = port_llm(tcfg, tparams, 1, 1).generate(prompts, sps)
    b = port_llm(tcfg, tparams, 2, 2).generate(prompts, sps)
    assert [o.token_ids for o in a] == [o.token_ids for o in b]
    assert a[1].token_ids != a[0].token_ids     # sampling did something


@pytest.mark.parametrize("knob", [
    dict(kw=dict(backend="local"), fault_plan=True, match="pipelined"),
    dict(kw=dict(prefix_cache=True, prefill_mode="exact"), match="chunked"),
    dict(kw=dict(), slo=dict(ttft_target_s=-1.0), match=">= 0"),
], ids=["fault_plan", "prefix_cache", "slo"])
def test_resilience_slice_knobs_are_validated(knob):
    """The resilience slice's knobs build a config (they raised until it
    was ported) and are validated as ``repro.serving.llm.EngineConfig``
    validates them: a fault plan needs the pipelined backend, the prefix
    cache chunked prefill, and an SLO target is >= 0."""
    from repro_torch.distributed.elastic import FaultPlan
    from repro_torch.serving.engine import SLOConfig
    kw = dict(knob["kw"])
    if knob.get("fault_plan"):
        kw["fault_plan"] = FaultPlan.parse(["drop@decode:1:0"])
        llm.EngineConfig(backend="pipelined", num_microbatches=2,
                         fault_plan=kw["fault_plan"])
    if "slo" in knob:
        kw["slo"] = SLOConfig(**knob["slo"])
        llm.EngineConfig(slo=SLOConfig(ttft_target_s=1.0))
    if kw.get("prefix_cache"):
        llm.EngineConfig(prefix_cache=True)
    with pytest.raises(ValueError, match=knob["match"]):
        llm.EngineConfig(**kw)


@pytest.mark.parametrize("knob", [dict(backend="pipelined"),
                                  dict(backend="pipelined",
                                       wire_dtype="int8")],
                         ids=["backend", "wire_dtype"])
def test_pipeline_slice_knobs_build(knob):
    """The pipeline slice's knobs build a config (they raised until the
    pipeline was ported)."""
    conf = llm.EngineConfig(num_microbatches=2, **knob)
    for name, value in knob.items():
        assert getattr(conf, name) == value


@pytest.mark.parametrize("plan_kw", ["deployment", "transport"])
def test_pipeline_slice_plan_knobs_build(plan_kw):
    """A multi-region deployment plan (or an explicit transport) yields a
    pipelined config with the plan's stage count and per-link transport,
    as ``repro.serving.llm.EngineConfig.plan`` does."""
    from repro_torch.distributed.transport import (DeploymentPlan,
                                                   SimulatedLinkTransport)
    dep = DeploymentPlan.from_regions(["us-west", "us-east", "eu"])
    kw = dict(deployment=dep) if plan_kw == "deployment" else dict(
        transport=SimulatedLinkTransport(dep.link_specs).bind(3),
        n_stages=3, latency=dep.max_link_latency)
    conf = llm.EngineConfig.plan(stage_time=0.1, m_kv_bytes=1e6,
                                 backend="pipelined", **kw)
    assert conf.backend == "pipelined" and conf.n_stages == 3
    assert conf.plan_args["n_stages"] == 3
    assert conf.plan_args["latency"] == dep.max_link_latency
    assert [l.latency_s for l in conf.transport.links] == \
        dep.link_latencies


def test_entry_points_never_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llm.LLM("yi-9b")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.obs, repro_torch.analysis\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")
