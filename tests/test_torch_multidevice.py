"""Pipeline stages placed by device in the port: each stage's weights,
caches, page-table copy and offloader on its own device, the activation
handed between devices, reshard and the fixed-batch passes over a device
list, float32 on the CPU.

The CPU has one device that computes, so the stream cases place stages on
``["cpu", "cpu"]``: the placement code is the only pipeline path, and it
must give the streams of ``mesh=None`` and of the JAX package's pipelined
engine, whose two stages sit on two host devices.  That side is the JAX
subprocess of ``tests/test_torch_pipeline.py`` (two host devices, the
engine cases only) and the reshard drill of ``tests/test_torch_fault.py``
(four host devices, the drill only), both started once for the file and
run side by side (about 30 s).  ``["cpu", "meta"]`` checks where every
tensor lands without computing anything.

- Placed init: ``init_params(layer_devices=)`` equals the one-device init
  bit for bit.
- Placement on ``["cpu", "meta"]``: every weight, cache, page-table copy
  and the tied head's table (``models.model.tied_head``) on its stage's
  device (reduced yi-9b, gemma3-12b, recurrentgemma-9b, phi3.5-moe),
  through the backend and the engine too; the engine places the weights
  it was given, the backend does not touch them.
- The exact prefill walking the stages (``models.model.prefill(stages=)``)
  equals the one-device prefill bit for bit, a tied head's table passed
  as a separate tensor.
- Streams at N_S = 2, N_B = 3, offload on: ``mesh=["cpu", "cpu"]`` equals
  ``mesh=None`` (greedy and sampled, log-probs within 1e-5) and the JAX
  two-device engine's greedy streams, on the fp32 and the int8 wire.
- Reshard 2 -> 1 -> 2 over ``["cpu", "cpu"]``, a drop in the first
  reshard's drain, gives the streams and the lost count of JAX's drill
  (2 -> 4 -> 1 over four host devices; the port's runs with
  ``mesh=None`` in ``tests/test_torch_fault.py``).
- The fixed-batch passes over a device list equal the one-device passes.
- Refusals: a mesh of the wrong length, stage 0 off the engine's device,
  a card past the visible ones, a reshard past the mesh.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401

from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.offload import DoubleBufferOffloader  # noqa: E402
from repro_torch.distributed.elastic import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.common import Runtime, stage_device  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.backend import (PipelinedBackend,  # noqa: E402
                                         stage_devices)
from repro_torch.serving.engine import OfflineEngine  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402

HERE = os.path.dirname(__file__)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
TOL = 1e-5
CPU, META = torch.device("cpu"), torch.device("meta")
STREAM_ARCHS = ("yi-9b", "gemma3-12b", "recurrentgemma-9b")
PLACED_ARCHS = ("yi-9b", "gemma3-12b", "recurrentgemma-9b",
                "phi3.5-moe-42b-a6.6b")


def _load(name):
    """A sibling test module by path, under a private name (its JAX
    subprocess script and its case constants)."""
    spec = importlib.util.spec_from_file_location(
        f"_multidevice_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TP = _load("test_torch_pipeline")
TF = _load("test_torch_fault")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX pipelined engines (two host devices) and the JAX reshard
    drill (four host devices), in two subprocesses run side by side."""
    tmp = tmp_path_factory.mktemp("jax_multidevice")
    pipe_spec = dict(setup=TP.SETUP, wires=[], decode={}, prefill={},
                     engines={a: TP.ENGINE_ARCHS[a] for a in STREAM_ARCHS},
                     pool=TP.ENGINE_POOL, new=TP.ENGINE_NEW,
                     links=TP.TRACED_LINKS)
    tcfg, _ = TF._port(TF.RESHARD_LAYERS)
    fault_spec = dict(plans={}, prompts=[], new=TF.NEW, pool=TF.FAULT_POOL,
                      engine=TF.FAULT_ENGINE,
                      reshard=dict(layers=TF.RESHARD_LAYERS,
                                   pool=TF.RESHARD_POOL,
                                   prompts=_reshard_prompts(tcfg),
                                   new=TF.RESHARD_NEW,
                                   steps=TF.RESHARD_STEPS))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               JAX_PLATFORMS="cpu")
    runs = {}
    for key, script, spec, out in (
            ("pipe", TP.JAX_SIDE, pipe_spec, tmp / "pipe.npz"),
            ("fault", TF.JAX_SIDE, fault_spec, tmp / "fault.json")):
        runs[key] = (out, subprocess.Popen(
            [sys.executable, "-c", script, str(out), json.dumps(spec)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    res = {}
    for key, (out, proc) in runs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
        res[key] = out
    with open(res["fault"]) as f:
        return dict(np.load(res["pipe"])), json.load(f)


def _reshard_prompts(tcfg):
    return TF._prompts(tcfg, TF.RESHARD_REQ, seed=3, lo=3, hi=14)


def _cfg(arch):
    cfg0 = get_arch(arch)
    period = len(cfg0.block_pattern)
    return reduced_config(cfg0, num_layers=2 * period + (2 if period > 1
                                                         else 1))


def _leaves(params):
    out = []
    for name, t in params["embed"].items():
        out.append((f"embed.{name}", t))
    out.append(("final_norm", params["final_norm"]))
    for i, layer in enumerate(params["layers"]):
        stack = [(f"layers.{i}", layer)]
        while stack:
            path, d = stack.pop()
            for k, v in d.items():
                if isinstance(v, dict):
                    stack.append((f"{path}.{k}", v))
                else:
                    out.append((f"{path}.{k}", v))
    return out


# ------------------------------------------------------------- placement


@pytest.mark.parametrize("arch", PLACED_ARCHS + ("qwen2-vl-2b",
                                                 "xlstm-1.3b"))
def test_placed_init_equals_one_device_init(arch):
    cfg = _cfg(arch)
    one = model_lib.init_params(cfg, 5, TRT, "cpu")
    placed = model_lib.init_params(
        cfg, 5, TRT, "cpu", layer_devices=PL.layer_devices(cfg, [CPU, CPU]))
    got, want = _leaves(placed), _leaves(one)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placement_on_cpu_and_meta(arch):
    """Stage 0 on the CPU, stage 1 on meta: the weights, the engine caches
    (through the backend, offloaders included), the page-table copies and
    the fixed-batch caches each on its stage's device."""
    cfg = _cfg(arch)
    devs = [CPU, META]
    per_layer = PL.layer_devices(cfg, devs)
    lo1, hi1 = PL.stage_ranges(cfg, 2)[1]
    assert per_layer[:lo1] == [CPU] * lo1
    assert per_layer[lo1:] == [META] * (cfg.num_layers - lo1) and hi1 > lo1
    params = model_lib.init_params(cfg, 0, TRT, "cpu",
                                   layer_devices=per_layer)
    for name, t in _leaves(params):
        if name.startswith("layers."):
            want = per_layer[int(name.split(".")[1])]
        elif name in ("embed.untok", "final_norm"):
            want = META
        else:
            want = CPU
        assert t.device == want, name

    pool = tkv.PoolConfig(page_size=4, n_local_pages=16, n_global_pages=4,
                          max_pages_per_seq=4)
    be = PipelinedBackend(cfg, params, TRT, mb_size=2, num_microbatches=2,
                          pool=pool, device="cpu", n_stages=2,
                          mesh=["cpu", "meta"], offload=True)
    assert be.stage_devices == devs
    tok = params["embed"]["tok"]
    if cfg.tie_embeddings:
        assert be.head.is_meta and be.head.shape == tok.shape
    else:
        assert be.head is None
    assert tok.device == CPU and "tok_head" not in params["embed"]
    for i, layer in enumerate(be.caches["layers"]):
        assert all(t.device == per_layer[i] for t in layer.values()), i
    assert be.caches["page_table"].device == CPU
    assert set(be.caches["page_tables"]) == {CPU, META}
    for dev, table in be.caches["page_tables"].items():
        assert table.device == dev and table.shape == (4, 4)
    assert tkv.slot_view(be.caches, 0, 2, META)["page_table"].device == META
    assert len(be.stage_offloaders) == 2

    pcfg = PL.PipelineConfig(n_stages=2, n_microbatches=2, mb_size=2)
    fixed = PL.init_pipeline_caches(cfg, pcfg, 16, TRT, devices=devs)
    for c in fixed["stage"] + [fixed["epilogue"]]:
        for i, layer in enumerate(c["layers"]):
            if layer is not None:
                assert all(t.device == per_layer[i]
                           for t in layer.values()), i


def test_place_params_moves_layers_and_the_tied_copy():
    """Re-placing weights moves only what changes device and counts its
    bytes; the embedding stays on stage 0's device, and a tied head's table
    is a copy made for the last stage's device only when that differs.
    An engine places the weights it is given; its backend does not."""
    cfg = _cfg("gemma3-12b")
    assert cfg.tie_embeddings
    params = model_lib.init_params(cfg, 0, TRT, "cpu")
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    assert model_lib.place_params(
        params, PL.layer_devices(cfg, [CPU, CPU])) == 0
    assert model_lib.tied_head(params, cfg, CPU) is None
    moved = model_lib.place_params(params,
                                   PL.layer_devices(cfg, [CPU, META]))
    on_meta = [t for n, t in _leaves(params) if t.device == META]
    assert moved == sum(t.numel() * t.element_size() for t in on_meta)
    assert 0 < moved < nbytes and params["embed"]["tok"].device == CPU
    head = model_lib.tied_head(params, cfg, META)
    assert head.is_meta and head.shape == params["embed"]["tok"].shape
    assert sorted(params["embed"]) == ["tok"]

    params = model_lib.init_params(cfg, 0, TRT, "cpu")
    pool = tkv.PoolConfig(page_size=4, n_local_pages=16,
                          max_pages_per_seq=4)
    PipelinedBackend(cfg, params, TRT, mb_size=2, num_microbatches=2,
                     pool=pool, device="cpu", n_stages=2,
                     mesh=["cpu", "meta"])
    assert params["layers"][-1]["wq"].device == CPU
    eng = OfflineEngine(cfg, params, TRT, mb_size=2, num_microbatches=2,
                        pool=pool, backend="pipelined", n_stages=2,
                        mesh=["cpu", "meta"], device="cpu")
    assert eng.moved_bytes == moved and eng.backend.head.is_meta
    assert params["layers"][-1]["wq"].is_meta


@pytest.mark.parametrize("arch", ("gemma3-12b", "recurrentgemma-9b"))
def test_stage_walked_prefill_equals_one_device(arch):
    """``prefill(stages=)`` over two stages, the tied head's table passed
    as its own tensor, equals the one-device prefill bit for bit: logits,
    rings and recurrent states."""
    cfg = _cfg(arch)
    assert cfg.tie_embeddings
    params = model_lib.init_params(cfg, 2, TRT, "cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        1, cfg.vocab_size, (2, 8)).astype(np.int32))
    last = torch.tensor([7, 4], dtype=torch.int32)
    one = model_lib.init_caches(cfg, 2, 16, TRT, "cpu")
    want, _ = model_lib.prefill(params, {"tokens": tokens}, cfg, TRT,
                                caches=one, last_index=last)
    walked = model_lib.init_caches(cfg, 2, 16, TRT, "cpu")
    stages = [(r, CPU, walked) for r in PL.stage_ranges(cfg, 2)]
    got, _ = model_lib.prefill(params, {"tokens": tokens}, cfg, TRT,
                               last_index=last, stages=stages,
                               head=params["embed"]["tok"].clone())
    assert torch.equal(got, want)
    for a, b in zip(one["layers"], walked["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------- streams


def _engine(tcfg, tparams, **kw):
    return llm.LLM(tcfg, config=TP._pipe_config(**kw), params=tparams,
                   rt=TRT, device="cpu")


@pytest.mark.parametrize("wire", ("fp32", "int8"))
@pytest.mark.parametrize("arch", STREAM_ARCHS)
def test_cpu_mesh_streams_equal_none_and_jax(jax_side, arch, wire):
    """Offload on (microbatches 0 and 2 contend for global parity 0); the
    greedy streams also equal the JAX two-device engine's on the fp32
    wire (the JAX engine case runs fp32)."""
    pipe, _ = jax_side
    tcfg, tparams, prompts = TP._engine_case(pipe, arch)
    sps = [SamplingParams(temperature=0.0 if i % 2 == 0 else 0.9,
                          max_new_tokens=TP.ENGINE_NEW, logprobs=True)
           for i in range(len(prompts))]
    runs = {}
    for label, mesh in (("none", None), ("cpu-cpu", ["cpu", "cpu"])):
        tl = _engine(tcfg, tparams, mesh=mesh, wire_dtype=wire)
        runs[label] = tl.generate(prompts, sps)
        assert tl.engine.backend.stage_devices == [CPU, CPU]
        assert tl.engine.backend.swap_count > 0
    for a, b in zip(runs["none"], runs["cpu-cpu"]):
        assert a.finished and a.token_ids == b.token_ids
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=TOL)
    if wire == "fp32":
        greedy = _engine(tcfg, tparams, mesh=["cpu", "cpu"]).generate(
            prompts, SamplingParams(temperature=0.0,
                                    max_new_tokens=TP.ENGINE_NEW))
        want = pipe[f"engine/{arch}/streams"]
        for i, o in enumerate(greedy):
            assert o.token_ids == [int(t) for t in want[i] if t >= 0], \
                f"{arch} request {i}"


def test_reshard_over_a_cpu_mesh_matches_jax(jax_side):
    """2 -> 1 -> 2 stages over the engine's mesh ``["cpu", "cpu"]`` (the
    second reshard takes both entries back), with JAX's drop during the
    first reshard's drain: the greedy streams and the lost count equal
    JAX's drill (2 -> 4 -> 1; the stage count does not change a token).
    A reshard past the mesh's two devices raises."""
    _, want = jax_side
    tcfg, tparams = TF._port(TF.RESHARD_LAYERS)
    prompts = _reshard_prompts(tcfg)
    tick, stage = want["reshard_drain_drop"]
    fp = FaultPlan([])
    pool = tkv.PoolConfig(**TF.RESHARD_POOL)
    eng = OfflineEngine(tcfg, tparams, TRT, mb_size=1, num_microbatches=4,
                        pool=pool, backend="pipelined", n_stages=2,
                        mesh=["cpu", "cpu"], prefill_chunk=4, fault_plan=fp,
                        offloader=DoubleBufferOffloader(pool, 4),
                        device="cpu")
    sp = SamplingParams(temperature=0.0, max_new_tokens=TF.RESHARD_NEW)
    seqs = eng.submit([Request(i, p, sp) for i, p in enumerate(prompts)])
    for _ in range(TF.RESHARD_STEPS[0]):
        assert eng.step()
    fp.events.append(FaultEvent("decode", tick, stage))
    with pytest.raises(ValueError, match="mesh has 2 device"):
        eng.reshard(n_stages=4)
    eng.reshard(n_stages=1)
    assert eng.backend.stage_devices == [CPU] and eng.mesh == [CPU] * 2
    for _ in range(TF.RESHARD_STEPS[1]):
        eng.step()
    eng.reshard(live_devices=4)             # bounded by the mesh: 2
    assert eng.backend.stage_devices == [CPU] * 2
    eng.run(max_steps=2000)
    assert [list(s.generated) for s in seqs] == want["reshard"]["streams"]
    assert eng.stats.decode_ticks_lost == want["reshard"]["decode_lost"]
    assert eng.stats.reshards == 2


# -------------------------------------------------------- fixed passes


@pytest.mark.parametrize("arch", ("yi-9b", "gemma3-12b"))
def test_fixed_passes_over_a_device_list(arch):
    """Prefill, a decode step and three greedy rounds over
    ``devices=[cpu, cpu]`` equal the one-device passes bit for bit."""
    cfg = _cfg(arch)
    params = model_lib.init_params(cfg, 1, TRT, "cpu")
    pcfg = PL.PipelineConfig(n_stages=2, n_microbatches=2, mb_size=2)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        1, cfg.vocab_size, (2, 2, 6)).astype(np.int32))
    outs = {}
    for label, devices in (("one", None), ("list", [CPU, CPU])):
        caches = PL.init_pipeline_caches(cfg, pcfg, 16, TRT, "cpu",
                                         devices=devices)
        logits, caches = PL.pipeline_prefill(params, tokens, caches, cfg,
                                             TRT, pcfg, devices=devices)
        nxt = logits.argmax(-1).to(torch.int32)
        pos = torch.full((2, 2), 6, dtype=torch.int32)
        step, caches = PL.pipeline_decode_step(params, nxt, caches, pos, cfg,
                                               TRT, pcfg, devices=devices)
        rounds, _ = PL.pipeline_decode_rounds(
            params, step.argmax(-1).to(torch.int32), caches, pos + 1, cfg,
            TRT, pcfg, rounds=3, devices=devices)
        outs[label] = (logits, step, rounds)
    for a, b in zip(outs["one"], outs["list"]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- refusals


def test_mesh_refusals(monkeypatch):
    cfg = _cfg("yi-9b")
    params = model_lib.init_params(cfg, 0, TRT, "cpu")
    with pytest.raises(ValueError, match="one device a stage"):
        llm.EngineConfig(backend="pipelined", n_stages=2,
                         num_microbatches=2, mesh=["cpu"] * 3)
    with pytest.raises(ValueError, match="one device a stage"):
        stage_devices(["cpu"], 2, "cpu")
    with pytest.raises(ValueError, match="stage 0 must be the engine"):
        OfflineEngine(cfg, params, TRT, mb_size=1, num_microbatches=2,
                      backend="pipelined", n_stages=2,
                      mesh=["meta", "cpu"], device="cpu")
    with pytest.raises(ValueError, match="mesh has 2 device"):
        OfflineEngine(cfg, params, TRT, mb_size=1, num_microbatches=4,
                      backend="pipelined", n_stages=2, mesh=["cpu", "cpu"],
                      device="cpu").reshard(n_stages=4)
    # a card past the visible ones, on a machine that shows one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert stage_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="1 card"):
        stage_devices(["cuda:0", "cuda:1"], 2, "cuda:0")


def test_serve_cli_places_stages_by_mesh(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--backend", "pipelined", "--stages",
                "2", "--microbatches", "2", "--mesh", "cpu,cpu",
                "--requests", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "on ['cpu', 'cpu']" in out and "finished 2/2 requests" in out
