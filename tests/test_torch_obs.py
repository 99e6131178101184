"""The port's flight recorder (``repro_torch.obs``) against ``repro.obs``,
and the traced port engines against the traced JAX engines, float32 on
the CPU.

- The recorder, the metrics registry and the timeline are host Python:
  fed the same call sequences, both packages give identical events,
  Chrome JSON, Prometheus text and JSONL lines (apart from the JSONL wall
  stamp), and the same schema verdicts on broken traces.
- Traced engines of both packages on tiny yi-9b (chunked prefill, with
  and without the prefix cache) and tiny gemma3 (exact prefill), greedy,
  on the same weights (``from_jax_params``): equal streams, equal
  per-request trace counts (chunks, pages, prefix-hit tokens, tokens) and
  equal event counts by (kind, name, track).
- The port on its own: the spans inside the backend's calls and the
  engine's booking, in order inside the engine's phases, and no clock
  read when off; a recorder attached and detached mid-serve changes no
  token; the export laid on a profiler trace's time base through the
  recorder's clock anchor, checked against ``torch.profiler`` markers;
  tracing and strict mode change no stream; the
  pipelined engine's link ledger reconciles with its transport bitwise;
  one offload swap window a swap; faults, recoveries and reshards are
  recorded as they are booked, and the recorder survives a reshard; the
  online front end's trace TTFT equals the stream's bitwise; trace off
  leaves no recorder anywhere; the serve CLI writes a trace that
  ``--check`` accepts.
"""

import collections
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import timeline as jtimeline  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving.kv_cache import PoolConfig as JaxPool  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.distributed.elastic import FaultPlan  # noqa: E402
from repro_torch.distributed.transport import (  # noqa: E402
    SimulatedLinkTransport)
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import timeline as ttimeline  # noqa: E402
from repro_torch.serving.llm import LLM, EngineConfig  # noqa: E402
from repro_torch.serving.kv_cache import PoolConfig  # noqa: E402
from repro_torch.serving.online import OnlineLLM  # noqa: E402
from repro_torch.serving.request import SamplingParams  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
POOL = dict(page_size=4, n_local_pages=48, max_pages_per_seq=12)
OFF_POOL = dict(page_size=4, n_local_pages=24, n_global_pages=8,
                max_pages_per_seq=8)
ENGINE = dict(mb_size=2, num_microbatches=2, prefill_chunk=8,
              max_prefill_tokens_per_tick=16)
NEW = 6
TRACE_KEYS = ("prompt_len", "chunks", "pages", "prefix_hit_tokens",
              "finish_reason")


# ------------------------------------------------- recorder / metrics ---


def _drive_recorder(mod, capacity):
    """One call sequence over every recording helper, with fixed stamps."""
    rec = mod.TraceRecorder(capacity=capacity, max_requests=3)
    rec.step_phase("reap", 1.0, 1.25, 0)
    rec.step_phase("prefill", 1.25, 1.5, 0)
    rec.step_phase("decode", 1.5, 2.0, 0)
    rec.pipe_tick("decode", 1.5, 2.0, (0, -1))
    rec.pipe_tick("prefill", 1.25, 1.5, (2, 0))
    for s in range(2):
        rec.stage_busy("decode", s, 0.1 * s, 0.1 * s + 0.064)
        rec.link_send("decode", s, 4096 + s, 0.5 + s, 0.564 + s,
                      return_trip=s == 1)
    rec.tick_stall("decode", 0.1 + 0.2, 0.7)
    rec.tick_stall("prefill", 1e-17, 0.9)
    rec.offload_swap_out(1, 2.1, True)
    rec.offload_swap_in(3, 2.1, 2.2)
    rec.prefix_event("hit", 4, 16, 2.3)
    rec.prefix_event("evict", 5, 8, 2.35)
    rec.slo_budget(0.25, 8, 2.4)
    rec.fault("drop", 2.5, (("plane", "decode"), ("mb", 1)))
    rec.fault("recover", 2.6, (("plane", "decode"), ("mb", 1)))
    rec.reshard_span("drain", 2.7, 2.8, (("old_stages", 2),))
    rec.reshard_span("rebuild", 2.8, 2.9, (("n_stages", 4),))
    rec.instant("mark", "engine", 3.0)
    rec.span("extra", "engine", 3.0, 3.5, data=(("k", 1),))
    for rid in range(5):        # the table holds 3: evictions and refusals
        rec.request_submit(rid, 1.0 + rid, 10 + rid)
        rec.request_admit(rid, 1.1 + rid)
        rec.request_chunk(rid, 8)
        rec.request_pages(rid, 3)
        rec.request_prefix_hit(rid, 4)
        rec.request_first_token(rid, 1.2 + rid)
        rec.request_tokens(rid, 1, 1.2 + rid)
        rec.request_tokens(rid, 2, 1.4 + rid)
        rec.request_stream_submit(rid, 0.9 + rid)
        rec.request_delivery(rid, 1.3 + rid, 2)
        if rid % 2 == 0:
            rec.request_finish(rid, 1.5 + rid, "length")
    return rec


@pytest.mark.parametrize("capacity", [4, 1024], ids=["evicting", "whole"])
def test_recorder_and_timeline_match_reference(capacity, tmp_path):
    j = _drive_recorder(jobs.trace, capacity)
    t = _drive_recorder(tobs.trace, capacity)
    assert [tuple(e) for e in t.events] == [tuple(e) for e in j.events]
    assert t.dropped == j.dropped
    assert (t.dropped > 0) == (capacity == 4)
    assert t.summary() == j.summary()
    assert t.link_ledger() == j.link_ledger()
    for rid in range(6):
        assert t.request_trace(rid) == j.request_trace(rid)
    # the port's export carries its recorder's clock anchor besides
    anchor = {"perf_counter_s": t.anchor[0], "epoch_ns": t.anchor[1]}
    ours = tobs.chrome_trace_events(t)
    assert ours["otherData"].pop("clock_anchor") == anchor
    assert ours == jobs.chrome_trace_events(j)
    want = jobs.write_chrome_trace(j, str(tmp_path / "j.json"))
    got = tobs.write_chrome_trace(t, str(tmp_path / "t.json"))
    assert tobs.validate_chrome_trace(got) == []
    assert got["otherData"].pop("clock_anchor") == anchor
    assert got == want
    written = json.loads((tmp_path / "t.json").read_text())
    assert written["otherData"].pop("clock_anchor") == anchor
    assert written == json.loads((tmp_path / "j.json").read_text())


def _broken_traces():
    ok = {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0, "dur": 1}
    return [
        {"traceEvents": "no"}, 7, [7],
        [{"ph": "Q", "name": "x"}],
        [dict(ok, ts=-1.0)], [dict(ok, dur=float("nan"))],
        [dict(ok), dict(ok, ts=2.0)],
        [{"name": "s", "ph": "b", "cat": "c", "id": 1, "ts": 3.0},
         {"name": "s", "ph": "e", "cat": "c", "id": 1, "ts": 2.0}],
        [{"name": "s", "ph": "b", "cat": "c", "id": 1, "ts": 3.0}],
        [{"name": "s", "ph": "e", "cat": "c", "id": 2, "ts": 3.0}],
        [{"name": "s", "ph": "b", "ts": 3.0}],
        [{"ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 0.0}],
    ]


def test_timeline_schema_check_matches_reference(tmp_path, capsys):
    for trace in _broken_traces():
        want = jtimeline.validate_chrome_trace(trace)
        assert want, trace
        assert ttimeline.validate_chrome_trace(trace) == want
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"traceEvents": _broken_traces()[6]}))
    assert ttimeline.main(["--check", str(path)]) == 1
    assert jtimeline.main(["--check", str(path)]) == 1


def test_check_cli_counts_a_bare_event_list(tmp_path, capsys):
    """A bare event list is a trace file ``validate_chrome_trace`` accepts;
    the reference's ``--check`` then raises counting its events (ROADMAP
    Queue 3), the port's reports it."""
    path = tmp_path / "list.json"
    path.write_text(json.dumps(_broken_traces()[6]))
    with pytest.raises(AttributeError):
        jtimeline.main(["--check", str(path)])
    assert ttimeline.main(["--check", str(path)]) == 1
    assert "1 problem(s) in 2 event(s)" in capsys.readouterr().out
    good = tmp_path / "good.json"
    tobs.write_chrome_trace(_drive_recorder(tobs.trace, 64), str(good))
    assert ttimeline.main(["--check", str(good)]) == 0
    assert "valid" in capsys.readouterr().out
    assert ttimeline.main(["--check", str(tmp_path / "none.json")]) == 2


class _FakeEngine:
    """Only ``throughput_report()``, as ``update_from_engine`` reads it."""

    def __init__(self, rep):
        self.rep = rep

    def throughput_report(self):
        return self.rep


REPORTS = [
    {"total_tokens": 40, "decode_tokens": 30, "prefill_tokens": 10,
     "finished": 3, "steps": 12, "swaps": 4, "tok_per_s": 10.5,
     "decode_tok_per_s": 8.25, "prefill_tok_per_s": 100.0,
     "wall_time_s": 3.75, "queue_depth": 2, "mean_latency_steps": 7.5,
     "status_counts": {"queued": 2, "decoding": 1, "finished": 3},
     "transport": {"transport": "simulated", "virtual_time_s": 1.5,
                   "wire_bytes": 8192, "link_sends": 4,
                   "link_stall_s": 0.25},
     "stages": {"ewma_s": [0.01, 0.03], "total_s": [0.1, 0.3],
                "counts": [10, 10], "microbatch_weights": [1.5, 0.5],
                "stragglers": [1]}},
    {"total_tokens": 90, "decode_tokens": 70, "prefill_tokens": 20,
     "finished": 5, "steps": 20, "swaps": 9, "prefix_hits": 2,
     "prefix_hit_tokens": 16, "decode_tok_per_s": 9.0,
     "status_counts": {"queued": 0, "decoding": 0, "finished": 5}},
]


def _drive_metrics(mod):
    m = mod.Metrics()
    snaps = [mod.update_from_engine(m, _FakeEngine(r)) for r in REPORTS]
    h = m.histogram("repro_ttft_s", help="time to first token")
    for v in (0.0005, 0.003, 0.2, 7.0, 100.0):
        h.observe(v)
    m.counter("repro_events_total", labels={"kind": "drop"}).inc(2)
    m.gauge("repro_temp", labels={"a": "1", "b": "x"}).set(3)
    return m, snaps


def test_metrics_match_reference():
    jm, jsnaps = _drive_metrics(jmetrics)
    tm, tsnaps = _drive_metrics(tmetrics)
    assert tsnaps == jsnaps
    assert tm.snapshot() == jm.snapshot()
    assert tm.prometheus_text() == jm.prometheus_text()
    assert tmetrics.Metrics.delta(*tsnaps) == jmetrics.Metrics.delta(*jsnaps)
    jl, tl = json.loads(jm.jsonl_line()), json.loads(tm.jsonl_line())
    assert isinstance(tl.pop("_ts"), float)
    jl.pop("_ts")
    assert tl == jl
    with pytest.raises(ValueError, match="backward"):
        tm.counter("repro_engine_steps_total").set_to(1.0)
    with pytest.raises(ValueError, match="decrease"):
        tm.counter("repro_engine_steps_total").inc(-1)
    with pytest.raises(ValueError, match="registered as"):
        tm.gauge("repro_engine_steps_total")


# ----------------------------------------------- engines, port vs JAX ---


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("yi-9b", "gemma3-1b"):
        jcfg = jax_reduced(jax_get_arch(arch))
        tcfg = reduced_config(get_arch(arch))
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  TRT, device="cpu")
        out[arch] = (jcfg, jparams, tcfg, tparams)
    return out


def _prompts(vocab, head=0, seed=1):
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(1, vocab, head))
    return [shared + list(rng.randint(1, vocab, n))
            for n in (13, 5, 22, 9, 17)]


def _port(tcfg, tparams, pool=POOL, **kw):
    cfg = dict(ENGINE, pool=PoolConfig(**pool))
    cfg.update(kw)
    return LLM(tcfg, config=EngineConfig(**cfg), params=tparams, rt=TRT,
               device="cpu")


# the port's own tracks (the spans inside the backend's calls and the
# engine's booking); the JAX package records neither
PORT_TRACKS = ("backend", "engine/host")


def _event_counts(rec, tracks=None):
    return collections.Counter((e.kind, e.name, e.track)
                               for e in rec.events
                               if tracks is None or e.track in tracks)


def _trace_counts(tr):
    out = {k: tr[k] for k in TRACE_KEYS}
    out["tokens"] = len(tr["token_times"])
    out["inter_tokens"] = len(tr["inter_token_s"])
    return out


@pytest.mark.parametrize("arch,prefix", [("yi-9b", False),
                                         ("yi-9b", True),
                                         ("gemma3-1b", False)],
                         ids=["yi-9b-chunked", "yi-9b-prefix-cache",
                              "gemma3-exact"])
def test_traced_engines_match_jax(models, arch, prefix):
    jcfg, jparams, tcfg, tparams = models[arch]
    prompts = _prompts(tcfg.vocab_size, head=12 if prefix else 0)
    pool = dict(POOL, max_pages_per_seq=16) if prefix else POOL
    kw = dict(ENGINE, trace=True, strict=True, prefix_cache=prefix)
    j = jax_llm.LLM(jcfg, config=jax_llm.EngineConfig(
        pool=JaxPool(**pool), **kw), params=jparams, rt=JRT)
    t = _port(tcfg, tparams, pool=pool, trace=True, strict=True,
              prefix_cache=prefix)
    assert t.engine.chunked_prefill == (arch == "yi-9b")
    want = j.generate(prompts, JaxSP(temperature=0.0, max_new_tokens=NEW))
    got = t.generate(prompts,
                     SamplingParams(temperature=0.0, max_new_tokens=NEW))
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    for g, w in zip(got, want):
        assert g.trace is not None
        assert _trace_counts(g.trace) == _trace_counts(w.trace)
        assert g.trace["ttft_s"] == g.ttft_s        # the same floats
        assert g.trace["token_times"][0] == g.trace["first_token_time"]
    ours = _event_counts(t.engine.recorder)
    own = _event_counts(t.engine.recorder, PORT_TRACKS)
    assert ours - own == _event_counts(j.engine.recorder)
    backend = t.engine.backend
    calls = backend.prefill_chunks if arch == "yi-9b" else \
        backend.exact_prefills
    for name in ("prefill.inputs", "prefill.launch", "prefill.wait"):
        assert own[("span", name, "backend")] == calls > 0
    for name in ("decode.inputs", "decode.noise", "decode.launch",
                 "decode.readout"):
        assert own[("span", name, "backend")] == backend.decode_ticks > 0
    if prefix:
        names = {e.name for e in t.engine.recorder.events}
        assert {"prefix_hit", "prefix_insert"} <= names
        assert sum(o.trace["prefix_hit_tokens"] for o in got) > 0
    assert t.engine.auditor.checks == j.engine.auditor.checks > 0
    # tracing and auditing change no stream
    plain = _port(tcfg, tparams, pool=pool, trace=None, strict=False,
                  prefix_cache=prefix)
    assert plain.engine.recorder is None and plain.engine.auditor is None
    again = plain.generate(prompts,
                           SamplingParams(temperature=0.0,
                                          max_new_tokens=NEW))
    assert [o.token_ids for o in again] == [o.token_ids for o in got]
    assert all(o.trace is None for o in again)


def test_trace_argument_forms(models):
    *_, tcfg, tparams = models["yi-9b"]
    shared = tobs.TraceRecorder(capacity=8)
    assert _port(tcfg, tparams, trace=shared).engine.recorder is shared
    assert _port(tcfg, tparams, trace=16).engine.recorder.capacity == 16
    assert _port(tcfg, tparams, trace=False).engine.recorder is None
    with pytest.raises(ValueError, match="trace must be"):
        _port(tcfg, tparams, trace="yes")
    # the planned build passes both knobs through
    planned = EngineConfig.plan(n_stages=2, stage_time=0.02, latency=0.064,
                                m_kv_bytes=2e6, page_size=4,
                                max_pages_per_seq=8, mb_size_cap=2,
                                trace=True, strict=True)
    eng = LLM(tcfg, config=planned, params=tparams, rt=TRT,
              device="cpu").engine
    assert eng.recorder is not None and eng.auditor is not None


# ----------------------------------------------------- the port alone ---


def _recorders(engine):
    """Every recorder reference the engine's stack holds."""
    be = engine.backend
    out = {"engine": engine.recorder,
           "backend": getattr(be, "recorder", None)}
    transport = getattr(be, "transport", None)
    if transport is not None:
        out["transport"] = transport.recorder
        inner = getattr(transport, "inner", None)
        if inner is not None:
            out["transport.inner"] = inner.recorder
    offs = [getattr(be, "offloader", None),
            *getattr(be, "stage_offloaders", ()),
            getattr(be, "epilogue_offloader", None)]
    for i, o in enumerate(o for o in offs if o is not None):
        out[f"offloader{i}"] = o.recorder
    return out


def _pipelined(tcfg, tparams, **kw):
    cfg = dict(ENGINE, pool=PoolConfig(**OFF_POOL), backend="pipelined",
               n_stages=2, num_microbatches=4, offload=True)
    cfg.update(kw)
    return LLM(tcfg, config=EngineConfig(**cfg), params=tparams, rt=TRT,
               device="cpu")


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_pipelined_ledger_reconciles_bitwise(models, wire, tmp_path):
    *_, tcfg, tparams = models["yi-9b"]
    prompts = _prompts(tcfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_new_tokens=NEW)
    ref = _port(tcfg, tparams, pool=OFF_POOL, num_microbatches=4,
                trace=None).generate(prompts, sp)
    llm = _pipelined(tcfg, tparams, wire_dtype=wire, trace=True,
                     strict=True,
                     transport=SimulatedLinkTransport.uniform(2, 0.064))
    eng = llm.engine
    got = llm.generate(prompts, sp)
    if wire == "fp32":
        assert [o.token_ids for o in got] == [o.token_ids for o in ref]
    assert all(o.finished and len(o.token_ids) == NEW for o in got)
    assert all(r is eng.recorder for r in _recorders(eng).values())
    rec = eng.recorder
    assert rec.dropped == 0
    ledger, books = rec.link_ledger(), eng.backend.transport_stats()
    assert ledger["wire_bytes"] == books["wire_bytes"]
    assert ledger["sends"] == books["link_sends"]
    assert ledger["stall_s"] == books["link_stall_s"]       # bitwise
    counts = _event_counts(rec)
    assert counts[("span", "tick", "pipe/decode")] == \
        eng.backend.decode_ticks
    assert counts[("span", "tick", "pipe/prefill")] == \
        eng.backend.prefill_ticks
    # one swap window a swap, one swap-out a departing microbatch
    assert counts[("span", "swap_in", "offload")] == \
        eng.backend.swap_count > 0
    assert 0 < counts[("instant", "swap_out", "offload")] <= \
        eng.backend.swap_count
    trace = tobs.write_chrome_trace(rec, str(tmp_path / "pipe.json"))
    assert tobs.validate_chrome_trace(
        json.loads((tmp_path / "pipe.json").read_text())) == []
    sent = sum(e["args"]["nbytes"] for e in trace["traceEvents"]
               if e.get("ph") == "b")
    assert sent == books["wire_bytes"]
    # the metrics registry reads the port's report as the reference's
    snap = tmetrics.update_from_engine(tmetrics.Metrics(), eng)
    rep = eng.throughput_report()
    assert snap["repro_engine_steps_total"] == rep["steps"]
    assert snap["repro_transport_wire_bytes"] == books["wire_bytes"]
    assert snap["repro_offload_swaps_total"] == rep["swaps"]
    assert 'repro_stage_time_ewma_s{stage="1"}' in snap


def test_faults_and_reshards_are_recorded(models):
    *_, tcfg, tparams = models["yi-9b"]
    prompts = _prompts(tcfg.vocab_size) * 2
    sp = SamplingParams(temperature=0.0, max_new_tokens=NEW)
    ref = _port(tcfg, tparams, pool=OFF_POOL, num_microbatches=4,
                trace=None).generate(prompts, sp)
    plan = FaultPlan.parse(["drop@decode:3:1", "drop@decode:5:0",
                            "drop@prefill:1:1", "delay@decode:2:0:0.05"])
    llm = _pipelined(tcfg, tparams, fault_plan=plan,
                     trace=True, strict=True,
                     transport=SimulatedLinkTransport.uniform(2, 0.01))
    eng = llm.engine
    seqs = eng.submit(llm._make_requests(prompts, sp))
    step, targets = 0, {10: 1, 18: 2}
    while eng.step():
        step += 1
        if step in targets:
            eng.reshard(n_stages=targets[step])
            # the recorder rides across the rebuilt pipe
            assert all(r is eng.recorder
                       for r in _recorders(eng).values())
    assert [s.generated for s in seqs] == [o.token_ids for o in ref]
    rep = eng.throughput_report()
    lost = rep["decode_ticks_lost"] + rep["prefill_chunks_lost"]
    assert lost >= 2 and rep["reshards"] == 2
    counts = _event_counts(eng.recorder)
    assert counts[("instant", "fault_drop", "faults")] == lost
    assert counts[("instant", "fault_recover", "faults")] == lost
    assert counts[("instant", "fault_delay", "faults")] == 1
    assert counts[("span", "reshard_drain", "reshard")] == 2
    assert counts[("span", "reshard_rebuild", "reshard")] == 2
    stages = [dict(e.data)["n_stages"] for e in eng.recorder.events
              if e.name == "reshard_rebuild"]
    assert stages == [1, 2]
    ledger, books = eng.recorder.link_ledger(), rep["transport"]
    assert ledger["wire_bytes"] == books["wire_bytes"]
    assert ledger["stall_s"] == books["link_stall_s"]
    assert eng.auditor.checks > step


def test_online_trace_ttft_is_the_streams(models):
    *_, tcfg, tparams = models["yi-9b"]
    llm = _port(tcfg, tparams, trace=True, strict=True)
    online = OnlineLLM(llm=llm)
    prompts = _prompts(tcfg.vocab_size)
    sps = [SamplingParams(temperature=0.0 if i % 2 else 0.8,
                          max_new_tokens=NEW) for i in range(len(prompts))]
    streams = [online.submit(p, sp) for p, sp in zip(prompts, sps)]
    online.run_until_idle()
    for s in streams:
        out = s.result()
        tr = out.trace
        assert tr["ttft_s"] == s.ttft_s                     # bitwise
        assert tr["inter_token_s"] == s.inter_token_s()
        assert tr["stream_submit_time"] == s.submit_time
        assert len(tr["delivery_times"]) == len(out.token_ids) == NEW


def test_threaded_pump_records_under_the_engine_lock(models):
    """Submitters on several threads while the pump thread steps: every
    recording call runs under the engine lock, so no request's trace
    loses a delivery or a token stamp, and each TTFT is its stream's."""
    *_, tcfg, tparams = models["yi-9b"]
    prompts = _prompts(tcfg.vocab_size) * 2
    sp = SamplingParams(temperature=0.0, max_new_tokens=NEW)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with OnlineLLM(llm=_port(tcfg, tparams, trace=True,
                                 strict=True)).start() as online:
            streams, lock = [], threading.Lock()

            def submit(ps):
                for p in ps:
                    s = online.submit(p, sp)
                    with lock:
                        streams.append(s)
            workers = [threading.Thread(target=submit, args=(prompts[i::4],))
                       for i in range(4)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
            outs = [s.result() for s in streams]
            assert online.close(timeout=10.0)
    finally:
        sys.setswitchinterval(interval)
    assert len(outs) == len(prompts)
    for s, o in zip(streams, outs):
        assert len(o.trace["delivery_times"]) == \
            len(o.trace["token_times"]) == NEW
        assert o.trace["ttft_s"] == s.ttft_s


def test_trace_off_carries_no_recorder(models):
    *_, tcfg, tparams = models["yi-9b"]
    engines = [_port(tcfg, tparams, pool=OFF_POOL).engine,
               _pipelined(tcfg, tparams, wire_dtype="int8",
                          transport=SimulatedLinkTransport.uniform(
                              2, 0.01)).engine]
    online = OnlineLLM(llm=_port(tcfg, tparams))
    online.submit([3, 4, 5], SamplingParams(max_new_tokens=2))
    online.run_until_idle()
    engines.append(online.engine)
    for eng in engines:
        refs = _recorders(eng)
        assert len(refs) >= 2
        assert all(r is None for r in refs.values()), refs
        assert eng.request_trace(0) is None


def test_serve_cli_writes_a_checked_trace(tmp_path):
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = tmp_path / "out.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new", "4", "--backend", "pipelined",
         "--link-latency", "0.064", "--inject-fault", "drop@decode:3:1",
         "--trace", str(out), "--strict"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "trace: wrote" in r.stdout and "0 dropped" in r.stdout
    assert "invariant audits passed" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.timeline", "--check",
         str(out)], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "valid" in r.stdout, r.stdout + r.stderr
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"decode", "tick", "send", "busy", "fault_drop"} <= names


def test_serve_cli_metrics_banner_and_full_size_alias():
    """``--metrics --metrics-every 2`` prints the JAX serve CLI's
    ``[metrics]`` banner every two engine steps, once more at exit, and
    the Prometheus text; ``--full-size`` is the JAX CLI's name for
    ``--full``."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new", "6", "--metrics",
         "--metrics-every", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    banners = [ln for ln in r.stdout.splitlines()
               if ln.startswith("[metrics] step=")]
    steps = [int(ln.split()[1].split("=")[1]) for ln in banners]
    assert steps[:-1] == list(range(2, 2 * len(steps) - 1, 2)), steps
    assert banners[-1].split()[3] == "finished=4/4"
    assert "metrics (Prometheus exposition):" in r.stdout
    assert "repro_tokens_total" in r.stdout
    from repro_torch.launch import serve
    for flag in ("--full-size", "--full"):
        assert serve.build_parser().parse_args([flag]).full
    assert not serve.build_parser().parse_args([]).full


# ------------------------------- spans inside the calls, on one clock ---


DECODE_SPANS = ["decode.inputs", "decode.noise", "decode.launch",
                "decode.readout"]
PREFILL_SPANS = ["prefill.inputs", "prefill.launch", "prefill.wait"]


def _mixed(prompts):
    """Alternately greedy and sampled requests."""
    return [SamplingParams(temperature=0.8 if i % 2 else 0.0, top_p=0.9,
                           max_new_tokens=NEW) for i in range(len(prompts))]


def _inside(ev, outer):
    return outer.t0 <= ev.t0 and ev.t0 + ev.dur <= outer.t0 + outer.dur


@pytest.mark.parametrize("backend", ["local", "pipelined"])
def test_backend_spans_nest_in_engine_phases(models, backend):
    """Each decode call records ``decode.inputs`` -> ``noise`` -> ``launch``
    -> ``readout``, each starting where the last ended, inside the engine's
    ``decode`` phase, and each prefill call its three ``prefill.*`` spans
    inside ``prefill``; the engine's booking sits inside its phases too."""
    *_, tcfg, tparams = models["yi-9b"]
    prompts = _prompts(tcfg.vocab_size)
    if backend == "local":
        llm = _port(tcfg, tparams, trace=True)
    else:
        llm = _pipelined(tcfg, tparams, trace=True)
    outs = llm.generate(prompts, _mixed(prompts))
    assert all(o.finished for o in outs)
    eng, be = llm.engine, llm.engine.backend
    events = list(eng.recorder.events)
    assert eng.recorder.dropped == 0
    phases = {n: [e for e in events if e.track == "engine" and e.name == n]
              for n in ("reap", "prefill", "decode")}
    inner = [e for e in events if e.track == "backend"]
    decode = [e for e in inner if e.name.startswith("decode.")]
    prefill = [e for e in inner if e.name.startswith("prefill.")]
    assert [e.name for e in decode] == DECODE_SPANS * be.decode_ticks
    n_prefill = be.prefill_chunks if backend == "local" else \
        be.prefill_ticks
    assert [e.name for e in prefill] == PREFILL_SPANS * n_prefill
    for group, n in ((decode, len(DECODE_SPANS)),
                     (prefill, len(PREFILL_SPANS))):
        for i in range(0, len(group), n):       # the spans tile a call
            call = group[i:i + n]
            for a, b in zip(call, call[1:]):
                assert b.t0 == pytest.approx(a.t0 + a.dur, abs=1e-9)
    rows = [dict(e.data)["rows"] for e in decode
            if e.name == "decode.noise"]
    assert max(rows) > 0 and min(rows) == 0 and max(rows) <= eng.mb_size
    for spans, phase in ((decode, "decode"), (prefill, "prefill")):
        for e in spans:
            assert any(_inside(e, p) for p in phases[phase]), (e, phase)
    host = [e for e in events if e.track == "engine/host"]
    where = {"build_chunk": "prefill", "apply_prefill": "prefill",
             "apply_decode": "decode"}
    assert {e.name for e in host} == set(where)
    for e in host:
        assert any(_inside(e, p) for p in phases[where[e.name]]), e
    # admission allocates a request's whole page budget, so no decode
    # row crosses into a page it does not hold: no push from the booking
    assert [dict(e.data)["pushes"] for e in host
            if e.name == "apply_decode"] == [0] * be.decode_ticks
    assert ttimeline.validate_chrome_trace(
        tobs.chrome_trace_events(eng.recorder)) == []


def test_recorder_off_takes_no_stamp(models, monkeypatch):
    """With the recorder off, ``LocalBackend.decode`` reads no clock; on,
    it reads one a span and one to start."""
    import time as time_mod
    *_, tcfg, tparams = models["yi-9b"]
    llm = _port(tcfg, tparams)
    eng = llm.engine
    prompts = _prompts(tcfg.vocab_size)
    eng.submit(llm._make_requests(prompts, _mixed(prompts)))
    while not eng.active[:eng.mb_size].any():
        eng.step()
    reads = {"n": 0}
    clock = time_mod.perf_counter

    def counted():
        reads["n"] += 1
        return clock()

    def call():
        lo, hi = 0, eng.mb_size
        samp = eng._row_sampling(lo, hi)
        assert samp.any_sampled and not samp.temp.all()
        monkeypatch.setattr(time_mod, "perf_counter", counted)
        try:
            with torch.inference_mode():        # as OfflineEngine.step
                eng.backend.decode(0, np.zeros((hi,), np.int32),
                                   eng.cur_pos[lo:hi], samp)
        finally:
            monkeypatch.setattr(time_mod, "perf_counter", clock)
        n, reads["n"] = reads["n"], 0
        return n

    assert eng.recorder is None
    assert call() == 0
    eng.set_recorder(tobs.TraceRecorder())
    assert call() == 1 + len(DECODE_SPANS)
    eng.set_recorder(None)
    assert call() == 0


@pytest.mark.parametrize("backend", ["local", "pipelined"])
def test_attach_and_detach_mid_serve(models, backend):
    """A recorder attached after a few steps and detached a few steps later
    changes no token; it records only between, on every part of the stack,
    and the requests submitted before it have no trace."""
    *_, tcfg, tparams = models["yi-9b"]
    prompts = _prompts(tcfg.vocab_size) * 2
    sps = _mixed(prompts)
    make = (lambda: _port(tcfg, tparams)) if backend == "local" else \
        (lambda: _pipelined(tcfg, tparams, transport=SimulatedLinkTransport
                            .uniform(2, 0.01)))
    ref = make().generate(prompts, sps)
    llm = make()
    eng = llm.engine
    seqs = eng.submit(llm._make_requests(prompts, sps))
    rec = tobs.TraceRecorder()
    step = 0
    while eng.step():
        step += 1
        if step == 4:
            eng.set_recorder(rec)
            assert all(r is rec for r in _recorders(eng).values())
        elif step == 12:
            n = len(rec.events)
            eng.set_recorder(None)
            assert all(r is None for r in _recorders(eng).values())
    assert [s.generated for s in seqs] == [o.token_ids for o in ref]
    assert len(rec.events) == n > 0
    steps = [dict(e.data)["step"] for e in rec.events if e.name == "reap"]
    assert steps == list(range(4, 12))
    assert rec.requests == {}
    assert eng.request_trace(0) is None


def test_export_on_a_profiler_time_base(models):
    """Without ``base_ns`` the wall events start near 0; with it each lands
    at ``(epoch_ns - base_ns) / 1e3`` µs through the anchor, events before
    the base are left out and counted, and both exports are valid."""
    *_, tcfg, tparams = models["yi-9b"]
    llm = _port(tcfg, tparams, trace=True)
    prompts = _prompts(tcfg.vocab_size)
    llm.generate(prompts, _mixed(prompts))
    rec = llm.engine.recorder
    plain = tobs.chrome_trace_events(rec)
    assert ttimeline.validate_chrome_trace(plain) == []
    xs = [e for e in plain["traceEvents"] if e["ph"] == "X"]
    assert min(e["ts"] for e in xs) == 0.0
    walls = [e for e in rec.events if e.clock == "wall"]
    mid = walls[len(walls) // 2]
    for base in (rec.epoch_ns(walls[0].t0) - 5_000_000, rec.epoch_ns(mid.t0)):
        laid = tobs.chrome_trace_events(rec, base_ns=base)
        assert ttimeline.validate_chrome_trace(laid) == []
        other = laid["otherData"]
        assert other["base_ns"] == base
        kept = [e for e in walls if rec.epoch_ns(e.t0) >= base]
        assert other["before_base"] == len(walls) - len(kept) > 0 or \
            base < rec.epoch_ns(walls[0].t0)
        got = [e for e in laid["traceEvents"] if e["ph"] == "X"
               and e["pid"] == 1]
        assert len(got) == sum(1 for e in kept if e.kind == "span")
        for ev, e in zip(got, [e for e in kept if e.kind == "span"]):
            assert ev["name"] == e.name
            assert ev["ts"] == pytest.approx(
                (rec.epoch_ns(e.t0) - base) / 1e3, abs=1e-3)
    # the anchor maps perf_counter onto the epoch at one instant
    perf, ns = rec.anchor
    assert rec.epoch_ns(perf) == ns
    assert rec.epoch_ns(perf + 1.5) - ns == 1_500_000_000


def test_spans_land_beside_profiler_markers(tmp_path):
    """Recorder spans laid on a CPU ``torch.profiler`` trace through the
    anchor start within 100 µs before ``record_function`` markers opened
    right after them."""
    import time as time_mod

    from torch.profiler import ProfilerActivity, profile, record_function
    rec = tobs.TraceRecorder()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with record_function("warm-up"):
        pass
    for i in range(20):
        t0 = time_mod.perf_counter()
        with record_function(f"mark{i}"):
            time_mod.sleep(0.0005)
        rec.span(f"mark{i}", "backend", t0, time_mod.perf_counter())
    prof.stop()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    marks = {e["name"]: e["ts"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("mark")}
    laid = tobs.chrome_trace_events(rec, base_ns=base)
    spans = {e["name"]: e["ts"] for e in laid["traceEvents"]
             if e["ph"] == "X"}
    assert set(spans) == set(marks) and len(marks) == 20
    leads = sorted(marks[n] - spans[n] for n in marks)
    assert leads[0] > -50.0, leads
    assert leads[len(leads) // 2] < 100.0, leads
    assert ttimeline.validate_chrome_trace(
        {"traceEvents": trace["traceEvents"] + laid["traceEvents"]}) == []


def test_lint_reaches_the_new_spans_unsuppressed():
    """The obs-hot-path pass scans the helpers that record the new spans
    (they are reachable from the hot roots) and finds nothing; no line of
    the backend or the engine suppresses it."""
    from pathlib import Path

    from repro_torch.analysis import lint
    root = Path(lint.__file__).resolve().parents[1]
    files, errors = lint.index_paths([root])
    assert not errors
    reach = lint.reachable_functions(files, lint.DEFAULT_HOT_ROOTS)
    for fn in ("_SlotCacheBackend._lap", "_SlotCacheBackend._draw_noise",
               "_SlotCacheBackend._load_inputs", "_SlotCacheBackend._load",
               "_SlotCacheBackend._read_out", "LocalBackend.decode",
               "PipelinedBackend._decode_tick"):
        assert f"serving.backend:{fn}" in reach, fn
    assert "serving.engine:OfflineEngine._decode_microbatch" in reach
    assert lint.run_lint([root], rules=["obs-hot-path"],
                         strict_suppressions=False) == []
    for fi in files:
        if fi.module in ("serving.backend", "serving.engine"):
            assert not any("obs-hot-path" in s.rules
                           for s in fi.suppressions), fi.path
