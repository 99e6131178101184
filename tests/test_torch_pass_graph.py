"""The fixed-batch passes captured a stage call at a time
(``repro_torch.core.pipeline.FixedPasses``), float32 on the CPU.

On the CPU a stage call runs eagerly through the same static inputs and
outputs that its captured graph reads and writes on the card (the routing
rule), so these tests hold the holder's ``prefill``, ``decode_step`` and
``decode_rounds`` against the functional passes (``pipeline_prefill``,
``pipeline_decode_step``, ``pipeline_decode_rounds``, the eager form) bit
for bit, logits, tokens and every cache leaf, and against the JAX
package's jitted passes at ``tests/test_torch_pipeline_fixed.py``'s
depths and tolerance (where the JAX passes raise, against JAX's plain
``prefill`` / ``decode_step``, as that file does).  ``CPUGraphs``
(``tests/test_torch_step_graph.py``) stands in for the card's graphs: its
capture runs the step once and its replay runs it again, so the warm-up's
state restore, one capture a key and the launch books are exercised here
too.  On the card ``chip_smoke.py`` holds real replays against the
functional passes (``[graph-parity]`` lines of phase 15).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from test_torch_pipeline_fixed import (GEOMETRY, JAX_SIDE, PIPE_CASES,  # noqa: E402,E501
                                       PLAIN_CASES, TOL, TRT, XLSTM_MATRICES,
                                       XLSTM_SCALE, _port_setup)
from test_torch_step_graph import CPUGraphs  # noqa: E402

# the models of tests/test_torch_pipeline_fixed.py: yi-shaped (no
# epilogue), (local, global) and (rglru, rglru, local) (an epilogue of two
# rglru layers), and yi-shaped at 3 layers (an attention epilogue)
MODELS = {"yi-9b": ("yi-9b", 4), "gemma3-12b": ("gemma3-12b", 12),
          "recurrentgemma-9b": ("recurrentgemma-9b", 8),
          "yi-9b-epilogue": ("yi-9b", 3)}
# the JAX oracle's cases, a subset of that file's
JAX_CASES = ("yi-9b", "gemma3-12b", "recurrentgemma-9b", "yi-9b-epilogue")
N_S, MB, SEQ, CAP, ROUNDS = 2, 2, 6, 32, 4


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(PL, "StepGraphs", CPUGraphs)


def _tokens(cfg, n_mb, mb, seed=1):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(1, cfg.vocab_size,
                                        (n_mb, mb, SEQ)).astype(np.int32))


def _leaves(caches):
    """Every cache leaf, by (part, layer, name)."""
    out = {}
    for p, part in enumerate(caches["stage"] + [caches["epilogue"]]):
        for i, layer in enumerate(part["layers"]):
            for name, t in (layer or {}).items():
                out[(p, i, name)] = t
    return out


def _assert_same_caches(got, want):
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _clone(caches):
    return {"stage": [{"layers": [None if c is None else
                                  {k: t.clone() for k, t in c.items()}
                                  for c in part["layers"]]}
                      for part in caches["stage"]],
            "epilogue": {"layers": [None if c is None else
                                    {k: t.clone() for k, t in c.items()}
                                    for c in caches["epilogue"]["layers"]]}}


@pytest.mark.parametrize("graphs", ["eager", "stand-in"])
@pytest.mark.parametrize("n_mb", [2, 3])
@pytest.mark.parametrize("name", list(MODELS))
def test_holder_equals_the_functional_passes(name, n_mb, graphs,
                                             monkeypatch):
    """A prefill, a decode step (on a copy of the caches' state: the
    holder's caches are put back after it) and four greedy rounds on a
    fresh prefill: the holder's logits, tokens and every cache leaf equal
    the functional passes' bit for bit, with the stage calls run eagerly
    (the CPU's routing) or through the stand-in's capture and replays."""
    if graphs == "stand-in":
        monkeypatch.setattr(PL, "StepGraphs", CPUGraphs)
    cfg, params = _port_setup(*MODELS[name])
    pcfg = PL.PipelineConfig(N_S, n_mb, MB)
    toks = _tokens(cfg, n_mb, MB)
    cur = torch.full((n_mb, MB), SEQ, dtype=torch.int32)
    fp = PL.FixedPasses(params, cfg, TRT, pcfg, CAP, device="cpu")
    want_c = PL.init_pipeline_caches(cfg, pcfg, CAP, TRT, device="cpu")
    got = fp.prefill(toks)
    want, want_c = PL.pipeline_prefill(params, toks, want_c, cfg, TRT, pcfg)
    assert torch.equal(got, want)
    _assert_same_caches(fp.caches, want_c)

    tok = want.argmax(-1).to(torch.int32)
    saved = _clone(fp.caches)
    got = fp.decode_step(tok, cur)
    want, _ = PL.pipeline_decode_step(params, tok, want_c, cur, cfg, TRT,
                                      pcfg)
    assert torch.equal(got, want)
    _assert_same_caches(fp.caches, want_c)

    for dst, src in zip(_leaves(fp.caches).values(),
                        _leaves(saved).values()):
        dst.copy_(src)
    want_c = _clone(saved)
    got = fp.decode_rounds(tok, cur, rounds=ROUNDS)
    want, _ = PL.pipeline_decode_rounds(params, tok, want_c, cur, cfg, TRT,
                                        pcfg, rounds=ROUNDS)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    _assert_same_caches(fp.caches, want_c)


def test_one_capture_a_key_and_a_second_prefill_replays(stand_in):
    """Every key is captured once; after ``reset`` a second prefill of the
    same prompts replays every step of the first and gives its logits and
    caches again (the reset cleared the states it starts from)."""
    cfg, params = _port_setup("recurrentgemma-9b", 8)
    n_mb = 3
    pcfg = PL.PipelineConfig(N_S, n_mb, MB)
    toks = _tokens(cfg, n_mb, MB)
    fp = PL.FixedPasses(params, cfg, TRT, pcfg, CAP, device="cpu")
    first = fp.prefill(toks)
    caches = _clone(fp.caches)
    st = fp.graphs.stats()
    keys = n_mb * N_S + 2                   # the stages, embed, head
    assert st["captures"] == st["keys"] == keys
    assert st["replays"] == keys and not st["eager_by_kind"]
    fp.reset()
    second = fp.prefill(toks)
    assert torch.equal(first, second)
    _assert_same_caches(fp.caches, caches)
    st = fp.graphs.stats()
    assert st["captures"] == keys and st["replays"] == 2 * keys
    assert set(fp.graphs.captures.values()) == {1}
    assert st["captures_by_kind"] == {"fixed-embed": 1,
                                      "fixed-prefill": n_mb * N_S,
                                      "fixed-prefill-head": 1}
    # the rounds: the decode stage keys and a drain a microbatch
    cur = torch.full((n_mb, MB), SEQ, dtype=torch.int32)
    tok = first.argmax(-1).to(torch.int32)
    fp.decode_rounds(tok, cur, rounds=2)
    st = fp.graphs.stats()
    assert st["captures_by_kind"]["fixed-decode"] == n_mb * N_S
    assert st["captures_by_kind"]["fixed-drain"] == n_mb
    assert st["replays_by_kind"]["fixed-decode"] == 2 * n_mb * N_S
    assert st["replays_by_kind"]["fixed-drain"] == 2 * n_mb
    assert st["decode_captures"] == st["prefill_captures"] == 0


def test_reset_clears_the_caches_to_their_initial_values():
    """``reset`` leaves the caches equal to fresh ones (positions -1,
    states 0, an sLSTM normaliser 1e-6), in place."""
    for arch, layers in (("recurrentgemma-9b", 8), ("xlstm-1.3b", 16)):
        cfg, params = _port_setup(arch, layers)
        pcfg = PL.PipelineConfig(N_S, 2, MB)
        fp = PL.FixedPasses(params, cfg, TRT, pcfg, CAP, device="cpu")
        before = {k: t.data_ptr() for k, t in _leaves(fp.caches).items()}
        fp.prefill(_tokens(cfg, 2, MB))
        fp.reset()
        _assert_same_caches(fp.caches, PL.init_pipeline_caches(
            cfg, pcfg, CAP, TRT, device="cpu"))
        assert {k: t.data_ptr() for k, t in _leaves(fp.caches).items()} == \
            before


def test_replays_add_the_captured_flash_and_scan_launches(monkeypatch,
                                                          stand_in):
    """With the plain kernels standing in for counted launches, a prefill
    through the stand-in's graphs counts what the functional prefill
    counts: N_B x the stages' local layers of flash, N_B x their rglru
    layers + the epilogue's rglru layers of scan; the capture's launches
    are put back and each replay adds them."""
    for fn_name, wrapper in (("flash_attention_ref", FA.flash_attention),
                             ("rglru_scan_ref", RS.rglru_scan)):
        orig = getattr(kops.ref, fn_name)

        def counted(*a, _orig=orig, _w=wrapper, **k):
            _w.launches += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kops.ref, fn_name, counted)
    cfg, params = _port_setup("recurrentgemma-9b", 8)
    n_mb = 3
    pcfg = PL.PipelineConfig(N_S, n_mb, MB)
    toks = _tokens(cfg, n_mb, MB)
    kinds = cfg.layer_kinds()
    staged = kinds[:PL.stage_ranges(cfg, N_S)[-1][0]]
    want = {"flash": n_mb * staged.count("local"),
            "scan": n_mb * staged.count("rglru") +
            kinds[len(staged):].count("rglru")}

    def counts(fn):
        f0, s0 = FA.flash_attention.launches, RS.rglru_scan.launches
        fn()
        return {"flash": FA.flash_attention.launches - f0,
                "scan": RS.rglru_scan.launches - s0}
    caches = PL.init_pipeline_caches(cfg, pcfg, CAP, TRT, device="cpu")
    assert counts(lambda: PL.pipeline_prefill(params, toks, caches, cfg, TRT,
                                              pcfg)) == want
    fp = PL.FixedPasses(params, cfg, TRT, pcfg, CAP, device="cpu")
    for _ in range(2):                      # captures, then replays
        fp.reset()
        assert counts(lambda: fp.prefill(toks)) == want
    assert fp.graphs.warmup_launches == {"flash_attention": want["flash"],
                                         "rglru_scan": want["scan"]}


def test_rounds_refuse_fewer_microbatches_than_stages():
    cfg, params = _port_setup("yi-9b", 4)
    fp = PL.FixedPasses(params, cfg, TRT, PL.PipelineConfig(2, 1, 2), 16,
                        device="cpu")
    z = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="N_B >= N_S"):
        fp.decode_rounds(z, z, rounds=2)
    with pytest.raises(ValueError, match="tokens has shape"):
        fp.decode_step(torch.zeros((2, 2), dtype=torch.int32), z)


def test_holder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    cfg, params = _port_setup("yi-9b", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.FixedPasses(params, cfg, TRT, PL.PipelineConfig(2, 2, 2), 16)


# ------------------------------------------------------- against the JAX side

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX oracle of ``JAX_CASES`` (``test_torch_pipeline_fixed``'s
    subprocess, restricted to them): the jitted passes where they run,
    the plain model where they raise."""
    path = str(tmp_path_factory.mktemp("jax_pass_graph") / "jax.npz")
    cases = {name: (*PIPE_CASES[name], "pipe") for name in JAX_CASES
             if name in PIPE_CASES}
    cases.update({name: (*PLAIN_CASES[name], "plain") for name in JAX_CASES
                  if name in PLAIN_CASES})
    spec = dict(geometry=GEOMETRY, cases=cases, xlstm_scale=XLSTM_SCALE,
                xlstm_matrices=XLSTM_MATRICES)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, path,
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=400)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", JAX_CASES)
def test_holder_matches_jax(jax_side, name, stand_in):
    """Through the stand-in's graphs, the holder's prefill and decode-step
    logits within ``TOL`` of the JAX passes' (or the plain model's), its
    greedy rounds equal theirs."""
    arch, layers, _ = {**PIPE_CASES, **PLAIN_CASES}[name]
    cfg, params = _port_setup(arch, layers)
    pcfg = PL.PipelineConfig(GEOMETRY["n_stages"], GEOMETRY["n_mb"],
                             GEOMETRY["mb"])
    fp = PL.FixedPasses(params, cfg, TRT, pcfg, GEOMETRY["cap"],
                        device="cpu")
    out = jax_side
    toks = torch.from_numpy(out[f"{name}/in/tokens"])
    tok = torch.from_numpy(out[f"{name}/tok"])
    cur = torch.from_numpy(out[f"{name}/cur"])
    logits = fp.prefill(toks)
    np.testing.assert_allclose(logits.numpy(), out[f"{name}/prefill"],
                               atol=TOL, rtol=TOL)
    saved = _clone(fp.caches)
    step = fp.decode_step(tok, cur)
    np.testing.assert_allclose(step.numpy(), out[f"{name}/step"], atol=TOL,
                               rtol=TOL)
    for dst, src in zip(_leaves(fp.caches).values(),
                        _leaves(saved).values()):
        dst.copy_(src)
    rounds = fp.decode_rounds(tok, cur, rounds=GEOMETRY["rounds"])
    np.testing.assert_array_equal(rounds.numpy(), out[f"{name}/rounds"])
    assert set(fp.graphs.captures.values()) == {1}
