"""Fault tolerance and elastic resharding in the port
(``PipelinedBackend(fault_plan=)``, ``OfflineEngine.reshard``, the
offloaders' host-store migration) against the JAX package, float32 on the
CPU.

The JAX pipeline needs one host device a stage, so its engines run in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
shared by every case of this file (about a minute of one core): the
2-stage engine under each fault plan below, and the reshard drill of
``tests/test_fault_tolerance.py``'s ``RESHARD_SCRIPT`` (2 -> 4 -> 1
stages, offload engaged, a drop during the first reshard's drain).  Both
packages use the weights of ``repro.models.model.init_params``
(``PRNGKey(0)``), carried across with ``from_jax_params``.

- A drop empties a stage's entry, so the port's tick runs the stage as a
  bubble; the engine injects the lost microbatch or chunk again.  Greedy
  and sampled streams equal the undisturbed run's, greedy streams and the
  lost counts equal the JAX engine's under the same plan.
- A delay inflates the delayed stage's observed seconds: the mitigator
  flags it and the prefill admission narrows.
- Reshard carries every request's progress across stage counts; the
  offloaders' host stores round-trip byte for byte through
  ``export_offload_state`` / ``import_offload_state``.
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
from repro_torch.core.offload import DoubleBufferOffloader  # noqa: E402
from repro_torch.distributed.elastic import (FailureDetector,  # noqa: E402
                                             FaultEvent, FaultPlan,
                                             StragglerMitigator)
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.backend import PipelinedBackend  # noqa: E402
from repro_torch.serving.engine import OfflineEngine  # noqa: E402
from repro_torch.serving.kv_cache import PoolConfig  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)

# the fault cases: reduced yi-9b (2 layers, one a stage), 2 stages, N_B 4
# of 2 rows (microbatches 0 and 2 share global parity 0, so the stage
# offloaders swap every round), prompts past the local pages
FAULT_POOL = dict(page_size=8, n_local_pages=12, n_global_pages=16,
                  max_pages_per_seq=8)
FAULT_ENGINE = dict(backend="pipelined", n_stages=2, mb_size=2,
                    num_microbatches=4, prefill_chunk=4,
                    max_prefill_tokens_per_tick=8)
N_REQ, NEW = 10, 6
# fault plans (CLI specs); "drain" is filled in from the undisturbed run's
# last ticks that only the last stage ran
PLANS = {
    "stage0": ["drop@decode:6:0", "drop@prefill:2:0"],
    "stage1": ["drop@decode:7:1", "drop@prefill:3:1"],
    "drain": [],
    # back to back: the tick after a stage-0 drop has nothing at stage 1
    "storm": ["drop@decode:8:0", "drop@decode:9:0", "drop@decode:11:1",
              "drop@prefill:1:0", "drop@prefill:3:1",
              "delay@decode:4:1:0.05"],
}
# the reshard drill: 5 layers (4 periods fill 4 stages, one leftover
# period), a small local pool and offloaded global pools
RESHARD_POOL = dict(page_size=8, n_local_pages=10, n_global_pages=16,
                    max_pages_per_seq=8)
RESHARD_LAYERS, RESHARD_REQ, RESHARD_NEW = 5, 8, 8
RESHARD_STEPS = (12, 10)        # 2 -> 4 after 12 steps, -> 1 after 10 more

JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import numpy as np
import jax
from repro.config import get_arch, reduced_config
from repro.core.offload import DoubleBufferOffloader
from repro.distributed.elastic import FaultEvent, FaultPlan
from repro.models import model as M
from repro.models.common import Runtime
import jax.numpy as jnp
from repro.serving.engine import OfflineEngine
from repro.serving.kv_cache import PoolConfig
from repro.serving.llm import LLM, EngineConfig
from repro.serving.request import Request, SamplingParams

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
rt = Runtime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
out = {}

cfg = reduced_config(get_arch("yi-9b"))
params = M.init_params(cfg, jax.random.PRNGKey(0), rt)
sp = SamplingParams(temperature=0.0, max_new_tokens=spec["new"])
for name, specs in spec["plans"].items():
    fp = FaultPlan.parse(specs)
    llm = LLM(cfg, params=params, rt=rt, config=EngineConfig(
        pool=PoolConfig(**spec["pool"]), offload=True, fault_plan=fp,
        **spec["engine"]))
    outs = llm.generate(spec["prompts"], sp, max_steps=2000)
    assert all(o.finished for o in outs)
    out[name] = dict(streams=[o.token_ids for o in outs],
                     decode_lost=llm.engine.stats.decode_ticks_lost,
                     prefill_lost=llm.engine.stats.prefill_chunks_lost,
                     pending=fp.pending())

R = spec["reshard"]
rcfg = reduced_config(get_arch("yi-9b"), num_layers=R["layers"])
rparams = M.init_params(rcfg, jax.random.PRNGKey(0), rt)
pool = PoolConfig(**R["pool"])
eng = OfflineEngine(rcfg, rparams, rt, mb_size=1, num_microbatches=4,
                    pool=pool, backend="pipelined", n_stages=2,
                    prefill_chunk=4, offloader=DoubleBufferOffloader(pool, 4),
                    fault_plan=FaultPlan([]))
rsp = SamplingParams(temperature=0.0, max_new_tokens=R["new"])
seqs = eng.submit([Request(i, p, rsp) for i, p in enumerate(R["prompts"])])
for _ in range(R["steps"][0]):
    assert eng.step()
occ = [s for s, e in enumerate(eng.backend._entries) if e is not None]
eng.backend.fault_plan.events.append(
    FaultEvent("decode", eng.backend._decode_ticks, occ[0]))
out["reshard_drain_drop"] = [eng.backend._decode_ticks, occ[0]]
eng.reshard(n_stages=4)
for _ in range(R["steps"][1]):
    eng.step()
eng.reshard(live_devices=1)
eng.run(max_steps=2000)
out["reshard"] = dict(streams=[list(s.generated) for s in seqs],
                      decode_lost=eng.stats.decode_ticks_lost,
                      reshards=eng.stats.reshards)
with open(out_path, "w") as f:
    json.dump(out, f)
print("OK")
"""


def _port(num_layers=None):
    kw = {} if num_layers is None else dict(num_layers=num_layers)
    jcfg = jax_reduced(jax_get_arch("yi-9b"), **kw)
    tcfg = reduced_config(get_arch("yi-9b"), **kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    return tcfg, from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                 TRT, device="cpu")


def _prompts(cfg, n, seed, lo, hi):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                         rng.randint(lo, hi))]
            for _ in range(n)]


def _sps(n, new, sampled=True):
    """Greedy and sampled requests side by side (greedy only if not
    ``sampled``)."""
    pol = [SamplingParams(temperature=0.0, max_new_tokens=new),
           SamplingParams(temperature=1.0, top_k=8, max_new_tokens=new),
           SamplingParams(temperature=0.7, top_p=0.9, max_new_tokens=new),
           SamplingParams(temperature=1.5, max_new_tokens=new)]
    return [pol[i % 4] if sampled else pol[0] for i in range(n)]


def _fault_llm(tcfg, tparams, fault_plan=None, **kw):
    conf = dict(FAULT_ENGINE, pool=PoolConfig(**FAULT_POOL), offload=True,
                fault_plan=fault_plan)
    conf.update(kw)
    return llm.LLM(tcfg, config=llm.EngineConfig(**conf), params=tparams,
                   rt=TRT, device="cpu")


def _watch(backend):
    """Record (plane, occupied) of every tick the backend runs."""
    seen = []
    orig = backend.transport.tick

    def tick(occupied, nbytes, compute_s, inject_t=0.0, plane="decode"):
        seen.append((plane, tuple(occupied)))
        return orig(occupied, nbytes, compute_s, inject_t=inject_t,
                    plane=plane)
    backend.transport.tick = tick
    return seen


def _drain_specs(tcfg, tparams, prompts):
    """Drops on the drain: the last decode tick and the last prefill tick
    of the undisturbed run in which only the last stage ran."""
    tl = _fault_llm(tcfg, tparams)
    seen = _watch(tl.engine.backend)
    tl.generate(prompts, _sps(len(prompts), NEW, sampled=False))
    specs = []
    for plane in ("decode", "prefill"):
        ticks = [occ for p, occ in seen if p == plane]
        t = max(i for i, occ in enumerate(ticks) if occ == (False, True))
        specs.append(f"drop@{plane}:{t}:1")
    return specs


@pytest.fixture(scope="module")
def setup():
    tcfg, tparams = _port()
    prompts = _prompts(tcfg, N_REQ, seed=3, lo=3, hi=17)
    plans = dict(PLANS, drain=_drain_specs(tcfg, tparams, prompts))
    return tcfg, tparams, prompts, plans


@pytest.fixture(scope="module")
def reshard_setup():
    tcfg, tparams = _port(RESHARD_LAYERS)
    return tcfg, tparams, _prompts(tcfg, RESHARD_REQ, seed=3, lo=3, hi=14)


@pytest.fixture(scope="module")
def jax_side(setup, reshard_setup, tmp_path_factory):
    """The JAX package's faulted engines and reshard drill, run once in a
    subprocess with four host devices."""
    tcfg, _, prompts, plans = setup
    path = str(tmp_path_factory.mktemp("jax_fault") / "jax.json")
    spec = dict(plans=plans, prompts=prompts, new=NEW, pool=FAULT_POOL,
                engine=FAULT_ENGINE,
                reshard=dict(layers=RESHARD_LAYERS, pool=RESHARD_POOL,
                             prompts=reshard_setup[2], new=RESHARD_NEW,
                             steps=RESHARD_STEPS))
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, path,
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _drops(specs, plane):
    return sum(1 for s in specs if s.startswith(f"drop@{plane}"))


# ------------------------------------------------------------------ gates


@pytest.mark.parametrize("gate", ["recurrent", "local", "stage"])
def test_fault_gates(gate):
    fp = FaultPlan([FaultEvent("decode", 0, 0)])
    if gate == "recurrent":
        # a replayed tick would step a recurrent state twice
        cfg = reduced_config(get_arch("recurrentgemma-9b"))
        with pytest.raises(ValueError, match="recurrent"):
            OfflineEngine(cfg, {}, TRT, mb_size=1, num_microbatches=1,
                          backend="pipelined", n_stages=1, fault_plan=fp,
                          device="cpu")
        return
    tcfg, tparams = _port()
    if gate == "local":
        with pytest.raises(ValueError, match="pipelined"):
            OfflineEngine(tcfg, tparams, TRT, fault_plan=fp, device="cpu")
        with pytest.raises(ValueError, match="pipelined"):
            llm.EngineConfig(backend="local", fault_plan=fp)
    else:
        with pytest.raises(ValueError, match="stage"):
            OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=2,
                          backend="pipelined", n_stages=2, device="cpu",
                          fault_plan=FaultPlan([FaultEvent("decode", 5, 2)]))


# ------------------------------------------------------------- drops


@pytest.mark.parametrize("plan", list(PLANS))
def test_faulted_streams_equal_undisturbed(setup, plan):
    """Greedy and sampled streams under each plan equal the undisturbed
    port run's; every event fired, every drop lost exactly one payload,
    and the lost work was not booked twice."""
    tcfg, tparams, prompts, plans = setup
    sps = _sps(N_REQ, NEW)
    ref = _fault_llm(tcfg, tparams)
    want = ref.generate(prompts, sps)
    fp = FaultPlan.parse(plans[plan])
    tl = _fault_llm(tcfg, tparams, fault_plan=fp)
    outs = tl.generate(prompts, sps)
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    assert all(o.finished for o in outs)
    assert fp.pending() == 0 and len(fp.triggered) == len(plans[plan])
    rep, clean = tl.stats(), ref.stats()
    assert rep["decode_ticks_lost"] == _drops(plans[plan], "decode")
    assert rep["prefill_chunks_lost"] == _drops(plans[plan], "prefill")
    assert rep["prefill_tokens"] == clean["prefill_tokens"]
    assert rep["decode_tokens"] == clean["decode_tokens"]
    be = tl.engine.backend
    assert be.swap_count > 0 and not be.pending() and \
        not be.prefill_pending()


@pytest.mark.parametrize("plan", list(PLANS))
def test_faulted_greedy_streams_match_jax(setup, jax_side, plan):
    tcfg, tparams, prompts, plans = setup
    fp = FaultPlan.parse(plans[plan])
    tl = _fault_llm(tcfg, tparams, fault_plan=fp)
    outs = tl.generate(prompts, _sps(N_REQ, NEW, sampled=False))
    want = jax_side[plan]
    assert [o.token_ids for o in outs] == want["streams"]
    assert tl.engine.stats.decode_ticks_lost == want["decode_lost"]
    assert tl.engine.stats.prefill_chunks_lost == want["prefill_lost"]
    assert fp.pending() == want["pending"] == 0


# -------------------------------------------------- stage times, delays


def test_delay_fault_lightens_prefill_admission():
    """While the mitigator flags a stage, the per-tick admission narrows
    (floored at one chunk) and recovers once the EWMA drains (the JAX
    test of the same name, on a 4-stage mitigator handed to the
    engine)."""
    tcfg, tparams = _port()
    eng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=2,
                        pool=PoolConfig(**FAULT_POOL), backend="pipelined",
                        n_stages=1, prefill_chunk=2,
                        max_prefill_tokens_per_tick=8, device="cpu")
    assert eng.prefill_rows == 4 and eng.straggler is not None
    assert eng._tick_prefill_rows() == 4        # cold: no straggler
    sm = StragglerMitigator(4)
    for _ in range(5):
        for s in range(3):
            sm.observe(s, 0.1)
        sm.observe(3, 1.0)
    eng.straggler = sm
    assert sm.stragglers() == [3]
    assert 1 <= eng._tick_prefill_rows() < 4
    for _ in range(50):
        sm.observe(3, 0.1)
    assert sm.stragglers() == []
    assert eng._tick_prefill_rows() == 4


def test_delayed_stage_is_flagged_end_to_end():
    """Four stages (a 5-layer model), stage 1 delayed on 8 consecutive
    decode ticks: the mitigator flags stage 1 and the admission width
    narrows while it is delayed; the streams do not change."""
    tcfg, tparams = _port(RESHARD_LAYERS)
    prompts = _prompts(tcfg, 12, seed=5, lo=20, hi=40)
    sps = _sps(12, 4, sampled=False)
    conf = dict(backend="pipelined", n_stages=4, mb_size=1,
                num_microbatches=4, prefill_chunk=4,
                max_prefill_tokens_per_tick=16,
                pool=PoolConfig(page_size=8, n_local_pages=64,
                                max_pages_per_seq=8))
    ref = llm.LLM(tcfg, config=llm.EngineConfig(**conf), params=tparams,
                  rt=TRT, device="cpu").generate(prompts, sps)
    fp = FaultPlan([FaultEvent("decode", t, 1, kind="delay", delay_s=0.5)
                    for t in range(4, 12)])
    tl = llm.LLM(tcfg, config=llm.EngineConfig(fault_plan=fp, **conf),
                 params=tparams, rt=TRT, device="cpu")
    eng = tl.engine
    widths, flagged = [], set()
    orig = eng._tick_prefill_rows

    def rows():
        w = orig()
        widths.append(w)
        flagged.update(eng.straggler.stragglers())
        return w
    eng._tick_prefill_rows = rows
    outs = tl.generate(prompts, sps)
    assert [o.token_ids for o in outs] == [o.token_ids for o in ref]
    assert fp.pending() == 0
    # stage 1 is flagged (wall-clock noise on a tick that ran only some
    # stages may flag another one too)
    assert 1 in flagged
    assert min(widths) < eng.prefill_rows == 4


@pytest.mark.parametrize("occupied,delays,stalls", [
    ((True, True, True, True), {}, (0.0, 0.0, 0.0, 0.0)),
    ((False, False, False, True), {}, (0.0, 0.0, 0.0, 0.0)),   # drain
    ((True, False, False, False), {2: 0.05}, (0.0, 0.0, 0.0, 0.0)),
    ((True, True, False, True), {1: 0.05}, (0.03, 0.0, 0.01, 0.02)),
])
def test_stage_observation_is_the_jax_share(occupied, delays, stalls):
    """A stage that ran or was delayed books what the JAX backend books
    for it (``dt / N_S`` plus delay plus link stall), so a tick that runs
    one stage alone reads lighter than a full one; a bubble that was not
    delayed is not observed."""
    from types import SimpleNamespace

    from repro.serving.backend import PipelinedBackend as JaxPipelined
    dt = 0.4
    jax_be = SimpleNamespace(n_stages=4, _stage_times=[])
    JaxPipelined._observe_stages(jax_be, dt, dict(delays), np.array(stalls))
    be = SimpleNamespace(n_stages=4, _stage_times=[])
    PipelinedBackend._observe_stages(be, dt, occupied, dict(delays),
                                     np.array(stalls))
    want = [(s, t) for s, t in jax_be._stage_times
            if occupied[s] or s in delays]
    assert be._stage_times == want


def test_stage_time_observations_reach_engine(setup):
    """One observation a stage that ran, each tick, drained into the
    engine's mitigator every step; a bubble is never observed (no
    0-second observation drags its EWMA down)."""
    tcfg, tparams, prompts, _ = setup
    tl = _fault_llm(tcfg, tparams)
    be = tl.engine.backend
    seen = _watch(be)
    obs = []
    orig = be.drain_stage_times

    def drain():
        out = orig()
        obs.extend(out)
        return out
    be.drain_stage_times = drain
    tl.generate(prompts, _sps(N_REQ, NEW, sampled=False))
    assert obs and all(dt > 0 for _, dt in obs)
    assert len(obs) == sum(sum(occ) for _, occ in seen)
    for s in range(2):
        assert tl.engine._stage_time_count[s] == \
            sum(occ[s] for _, occ in seen)
    assert all(t > 0 for t in tl.engine.straggler.ewma)
    assert be.drain_stage_times() == []
    rep = tl.stats()["stages"]
    assert rep["counts"] == tl.engine._stage_time_count


# ------------------------------------------------------------- reshard


def test_reshard_refuses_local_backend_and_overdeep_pipe():
    tcfg, tparams = _port()
    eng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=1,
                        device="cpu")
    with pytest.raises(ValueError, match="pipelined"):
        eng.reshard(n_stages=1)
    peng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=2,
                         backend="pipelined", n_stages=1, device="cpu")
    with pytest.raises(ValueError, match="N_B >= N_S"):
        peng.reshard(n_stages=3)
    with pytest.raises(ValueError, match="live_devices"):
        peng.reshard()


def _reshard_run(tcfg, tparams, prompts, plan=None, fault_plan=None):
    """The reshard drill's engine (2 stages, N_B 4 of one row, offloaded
    pools); ``plan`` is a list of ``(step, reshard kwargs)``.  Returns the
    streams, the streams at each reshard, and the engine."""
    pool = PoolConfig(**RESHARD_POOL)
    eng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=4,
                        pool=pool, backend="pipelined", n_stages=2,
                        prefill_chunk=4, fault_plan=fault_plan,
                        offloader=DoubleBufferOffloader(pool, 4),
                        device="cpu")
    sp = SamplingParams(temperature=0.0, max_new_tokens=RESHARD_NEW)
    seqs = eng.submit([Request(i, p, sp) for i, p in enumerate(prompts)])
    snaps, step = [], 0
    todo = dict(plan or [])
    while eng.step():
        step += 1
        if step in todo:
            assert eng.backend.swap_count > 0, "the offloader never swapped"
            snaps.append([list(s.generated) for s in seqs])
            eng.reshard(**todo[step])
        assert step < 2000
    return [list(s.generated) for s in seqs], snaps, eng


RESHARD_PLAN = [(RESHARD_STEPS[0], dict(n_stages=4)),
                (sum(RESHARD_STEPS), dict(live_devices=1))]


def test_reshard_mid_run_bit_identical(reshard_setup):
    """2 -> 4 -> 1 stages mid-run with offload engaged: the streams equal
    an undisturbed 2-stage run's, and no request generates a token twice
    (every stream at a reshard is a prefix of its final stream)."""
    tcfg, tparams, prompts = reshard_setup
    ref, _, _ = _reshard_run(tcfg, tparams, prompts)
    out, snaps, eng = _reshard_run(tcfg, tparams, prompts, RESHARD_PLAN)
    assert out == ref
    assert eng.stats.reshards == 2 and eng.backend.n_stages == 1
    assert any(any(s) for s in snaps[0])
    for snap in snaps:
        for pre, toks in zip(snap, out):
            assert toks[:len(pre)] == pre
    assert eng.stats.decode_tokens == sum(len(t) for t in ref)


def test_reshard_matches_jax(reshard_setup, jax_side):
    """The JAX reshard drill (with its drop during the first reshard's
    drain) and the port's give the same greedy streams."""
    tcfg, tparams, prompts = reshard_setup
    tick, stage = jax_side["reshard_drain_drop"]
    fp = FaultPlan([])
    pool = PoolConfig(**RESHARD_POOL)
    eng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=4,
                        pool=pool, backend="pipelined", n_stages=2,
                        prefill_chunk=4, fault_plan=fp,
                        offloader=DoubleBufferOffloader(pool, 4),
                        device="cpu")
    sp = SamplingParams(temperature=0.0, max_new_tokens=RESHARD_NEW)
    seqs = eng.submit([Request(i, p, sp) for i, p in enumerate(prompts)])
    for _ in range(RESHARD_STEPS[0]):
        assert eng.step()
    occ = [s for s, e in enumerate(eng.backend._entries) if e is not None]
    assert [eng.backend.decode_ticks, occ[0]] == [tick, stage]
    fp.events.append(FaultEvent("decode", tick, stage))
    eng.reshard(n_stages=4)
    for _ in range(RESHARD_STEPS[1]):
        eng.step()
    eng.reshard(live_devices=1)
    eng.run(max_steps=2000)
    want = jax_side["reshard"]
    assert [list(s.generated) for s in seqs] == want["streams"]
    assert eng.stats.decode_ticks_lost == want["decode_lost"] == 1
    assert eng.stats.reshards == want["reshards"] == 2


def test_reshard_by_failure_detector(reshard_setup):
    """A detector on the step clock: device 3 of 4 goes silent, the
    planner's target for 3 live devices is 2 stages, and the streams equal
    the undisturbed run's."""
    tcfg, tparams, prompts = reshard_setup
    ref, _, _ = _reshard_run(tcfg, tparams, prompts)
    pool = PoolConfig(**RESHARD_POOL)
    eng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=4,
                        pool=pool, backend="pipelined", n_stages=4,
                        prefill_chunk=4,
                        offloader=DoubleBufferOffloader(pool, 4),
                        device="cpu")
    sp = SamplingParams(temperature=0.0, max_new_tokens=RESHARD_NEW)
    seqs = eng.submit([Request(i, p, sp) for i, p in enumerate(prompts)])
    fd = FailureDetector(timeout=2.0)
    step, plan = 0, None
    while eng.step():
        step += 1
        for d in range(4):
            if d != 3 or step <= 6:
                fd.beat(d, float(step))
        if fd.dead(float(step)) and plan is None:
            plan = eng.reshard(detector=fd, now=float(step))
    assert step > 9 and plan is not None and plan["batch_reshard"]
    assert eng.backend.n_stages == 2 and fd.dead(float(step)) == [3]
    assert [list(s.generated) for s in seqs] == ref


@pytest.mark.parametrize("n_to", [1, 2, 4])
@pytest.mark.parametrize("n_from", [1, 2, 4])
def test_offload_state_round_trips(reshard_setup, n_from, n_to):
    """Seeded pools, each microbatch made resident in turn at every stage
    unit (so each unit holds some microbatches resident and the rest in
    its host store), exported, imported into a backend of another stage
    count over the same caches, exported again: byte for byte the same."""
    tcfg, tparams, _ = reshard_setup
    pool = PoolConfig(**RESHARD_POOL)
    kw = dict(mb_size=1, num_microbatches=4, pool=pool,
              device=torch.device("cpu"), offload=True)
    be = PipelinedBackend(tcfg, tparams, TRT, n_stages=n_from, **kw)
    gen = torch.Generator().manual_seed(n_from * 10 + n_to)
    units = be._offload_units()
    assert len(units) == n_from + (1 if be.ranges[-1][0] <
                                   be.ranges[-1][1] else 0)
    for mb in (0, 1, 2, 3, 1):
        for o, lo, hi in units:
            for layer in be.caches["layers"][lo:hi]:
                for name in ("k_pages", "v_pages"):
                    layer[name].copy_(torch.randn(layer[name].shape,
                                                  generator=gen))
            o.ensure_resident({"layers": be.caches["layers"][lo:hi]}, mb)
    first = be.export_offload_state()
    assert sorted(first) == [0, 1, 2, 3]
    snap = {mb: t.clone() for mb, t in first.items()}
    other = PipelinedBackend(tcfg, tparams, TRT, n_stages=n_to,
                             caches=be.caches, **kw)
    other.import_offload_state(first)
    again = other.export_offload_state()
    assert sorted(again) == [0, 1, 2, 3]
    for mb in snap:
        assert torch.equal(again[mb].view(torch.int32),
                           snap[mb].view(torch.int32)), mb


def test_serve_cli_fault_and_reshard():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--backend",
         "pipelined", "--inject-fault", "drop@decode:5:1", "--reshard-at",
         "20:1", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "finished 16/16 requests" in r.stdout
    assert "resharded at step 20: 2 -> 1 stages" in r.stdout
    assert "decode ticks lost 1" in r.stdout
