"""The fixed-batch passes of DeServe's §4.3 circular pipeline in the port
(``repro_torch.core.pipeline``: ``pipeline_prefill``,
``pipeline_decode_step``, ``pipeline_decode_rounds``) against the JAX
package, float32 on the CPU.

The JAX passes run their stages inside one ``shard_map`` over the ``pod``
axis, so the oracle runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` on a ``(2, 1, 1)``
``("pod", "data", "model")`` mesh, shared by every case of this file (about
a minute of one core).  Both packages use the weights of
``repro.models.model.init_params`` (``PRNGKey(0)``), carried across with
``from_jax_params``, and the same seeded inputs, at N_S = 2, N_B = 3 and
mb = 4.

- ``PIPE_CASES``: the JAX passes are the oracle.  Each depth leaves no
  attention layer in the epilogue: under jax 0.9.0's explicit-axis
  ``make_mesh`` the JAX passes raise a ``ShardingTypeError`` when an
  epilogue attention layer writes its cache over the global batch.
  yi-9b at 4 layers and gemma3-12b at 12 have no epilogue,
  recurrentgemma-9b at 8 an epilogue of two rglru layers, xlstm-1.3b at
  16 (two 8-layer periods) none; musicgen-large takes ``{"frames"}`` and
  qwen2-vl-2b ``{"tokens", "patches"}``.
- ``PLAIN_CASES``: JAX's plain ``prefill`` / ``decode_step`` are the
  oracle, as ``tests/test_pipeline_spmd.py`` holds the JAX passes to them.
  yi-9b at 3 layers and gemma3-12b at 14 put attention layers in the
  epilogue (where the JAX passes raise).  phi3.5-moe and qwen3-moe: the
  JAX pass raises on the explicit-axis mesh in ``constrain_expert_dim``,
  so the plain model is the oracle.  A stage call routes one microbatch
  and the plain model the whole batch, so they could differ where an
  expert drops tokens; ``reduced_config`` gives 4 experts, top-2 and a
  capacity factor of 2.0, a capacity per expert equal to the call's token
  count, so nothing is dropped on either side.

xlstm-1.3b's random-init model magnifies a float32 rounding difference
block by block (``tests/test_torch_model.py``, ``XLSTM_TOL``); with its
mLSTM / sLSTM matrices scaled by ``XLSTM_SCALE`` in both packages alike
the recurrence contracts and the whole model agrees within ``TOL``, as
``test_xlstm_model_gap_is_the_random_inits_amplification`` shows, so that
case runs on the scaled weights.

Prefill and decode-step logits agree within ``TOL``; the greedy tokens of
``pipeline_decode_rounds`` (R rounds) equal JAX's rounds, or, against the
plain model, R sequential greedy decodes.
"""

import functools
import json
import os
import subprocess
import sys

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
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
TOL = 1e-5
GEOMETRY = dict(n_stages=2, n_mb=3, mb=4, seq=6, cap=32, rounds=4)
# case: (arch, layers, input kind)
PIPE_CASES = {"yi-9b": ("yi-9b", 4, "tokens"),
              "gemma3-12b": ("gemma3-12b", 12, "tokens"),
              "recurrentgemma-9b": ("recurrentgemma-9b", 8, "tokens"),
              "xlstm-1.3b": ("xlstm-1.3b", 16, "tokens"),
              "musicgen-large": ("musicgen-large", 4, "frames"),
              "qwen2-vl-2b": ("qwen2-vl-2b", 4, "patches")}
PLAIN_CASES = {"yi-9b-epilogue": ("yi-9b", 3, "tokens"),
               "gemma3-12b-epilogue": ("gemma3-12b", 14, "tokens"),
               "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", 4, "tokens"),
               "qwen3-moe": ("qwen3-moe-235b-a22b", 4, "tokens")}
CASES = {**PIPE_CASES, **PLAIN_CASES}
XLSTM_SCALE = 0.5
XLSTM_MATRICES = ("wm", "wz", "wq", "wk", "wv", "wo", "w_in", "r")


def _scale_xlstm(params, arch):
    """xlstm-1.3b's mLSTM / sLSTM matrices times ``XLSTM_SCALE`` (the other
    archs unchanged)."""
    if arch != "xlstm-1.3b":
        return params
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a * XLSTM_SCALE
        if getattr(p[-1], "key", None) in XLSTM_MATRICES else a, params)

JAX_SIDE = r"""
import json, os, sys
# one host device a stage; one thread each, as the suite runs files on
# several workers at once
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import numpy as np
import jax, jax.numpy as jnp
from repro.config import get_arch, reduced_config
from repro.core import pipeline as PL
from repro.models import model as M
from repro.models.common import Runtime

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
G = spec["geometry"]
NS, NB, MB, S, CAP, R = (G[k] for k in ("n_stages", "n_mb", "mb", "seq",
                                        "cap", "rounds"))
B = NB * MB
rt = Runtime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
mesh = jax.make_mesh((NS, 1, 1), ("pod", "data", "model"))
pcfg = PL.PipelineConfig(n_stages=NS, n_microbatches=NB, mb_size=MB)
out = {}


def inputs(cfg, kind, rng):
    if kind == "frames":
        return {"frames": rng.standard_normal(
            (NB, MB, S, cfg.d_model)).astype(np.float32)}
    x = {"tokens": rng.randint(1, cfg.vocab_size, (NB, MB, S)).astype(
        np.int32)}
    if kind == "patches":
        x["patches"] = rng.standard_normal(
            (NB, MB, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return x


for name, (arch, layers, kind, oracle) in spec["cases"].items():
    cfg = reduced_config(get_arch(arch), num_layers=layers)
    params = M.init_params(cfg, jax.random.PRNGKey(0), rt)
    if arch == "xlstm-1.3b":
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: a * spec["xlstm_scale"]
            if getattr(p[-1], "key", None) in spec["xlstm_matrices"] else a,
            params)
    x = inputs(cfg, kind, np.random.RandomState(1))
    for k, v in x.items():
        out[f"{name}/in/{k}"] = v
    n_seq = S + (cfg.num_patch_tokens if kind == "patches" else 0)
    cur = np.full((NB, MB), n_seq, np.int32)
    if oracle == "pipe":
        with mesh:
            prefill = jax.jit(lambda p, i, c: PL.pipeline_prefill(
                p, i, c, cfg, rt, pcfg))
            caches = PL.init_pipeline_caches(cfg, pcfg, CAP, rt)
            logits, caches = prefill(params, jax.tree.map(jnp.asarray, x),
                                     caches)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            step, _ = jax.jit(lambda p, t, c, cp: PL.pipeline_decode_step(
                p, t, c, cp, cfg, rt, pcfg))(params, tok, caches,
                                             jnp.asarray(cur))
            # a fresh prefill for the rounds (the step wrote its caches)
            caches = PL.init_pipeline_caches(cfg, pcfg, CAP, rt)
            _, caches = prefill(params, jax.tree.map(jnp.asarray, x), caches)
            rounds, _ = jax.jit(lambda p, t, c, cp: PL.pipeline_decode_rounds(
                p, t, c, cp, cfg, rt, pcfg, rounds=R))(params, tok, caches,
                                                       jnp.asarray(cur))
        out[f"{name}/rounds"] = np.asarray(rounds)
    else:
        flat = {k: jnp.asarray(v.reshape((B,) + v.shape[2:]))
                for k, v in x.items()}
        decode = jax.jit(lambda p, t, c, cp: M.decode_step(p, t, c, cp, cfg,
                                                           rt))
        logits, caches = jax.jit(lambda p, i: M.prefill(p, i, cfg, rt, CAP))(
            params, flat)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        step, _ = decode(params, tok, caches, jnp.asarray(cur.reshape(B)))
        seq, t, c = [], tok, caches
        for r in range(R):
            lg, c = decode(params, t, c, jnp.asarray(cur.reshape(B) + r))
            t = jnp.argmax(lg, -1).astype(jnp.int32)
            seq.append(np.asarray(t).reshape(NB, MB))
        out[f"{name}/rounds"] = np.stack(seq)
    out[f"{name}/prefill"] = np.asarray(logits).reshape(NB, MB, -1)
    out[f"{name}/tok"] = np.asarray(tok).reshape(NB, MB)
    out[f"{name}/cur"] = cur
    out[f"{name}/step"] = np.asarray(step).reshape(NB, MB, -1)
    print(name, "done", flush=True)
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX oracle of every case, run once in a subprocess with two
    host devices."""
    path = str(tmp_path_factory.mktemp("jax_fixed") / "jax.npz")
    cases = {name: (*c, "pipe") for name, c in PIPE_CASES.items()}
    cases.update({name: (*c, "plain") for name, c in PLAIN_CASES.items()})
    spec = dict(geometry=GEOMETRY, cases=cases, xlstm_scale=XLSTM_SCALE,
                xlstm_matrices=XLSTM_MATRICES)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, path,
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=400)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(path))


@functools.lru_cache(maxsize=None)
def _port_setup(arch, layers):
    jcfg = jax_reduced(jax_get_arch(arch), num_layers=layers)
    tcfg = reduced_config(get_arch(arch), num_layers=layers)
    jparams = _scale_xlstm(
        jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT), arch)
    return tcfg, from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                 TRT, device="cpu")


def _pcfg():
    return PL.PipelineConfig(n_stages=GEOMETRY["n_stages"],
                             n_microbatches=GEOMETRY["n_mb"],
                             mb_size=GEOMETRY["mb"])


def _prefill(name, out):
    """The port's pipelined prefill of the case's inputs on fresh caches:
    (logits, caches, cfg, params)."""
    arch, layers, _ = CASES[name]
    cfg, params = _port_setup(arch, layers)
    pcfg = _pcfg()
    caches = PL.init_pipeline_caches(cfg, pcfg, GEOMETRY["cap"], TRT,
                                     device="cpu")
    inputs = {k.split("/")[-1]: torch.from_numpy(v)
              for k, v in out.items() if k.startswith(f"{name}/in/")}
    logits, caches = PL.pipeline_prefill(params, inputs, caches, cfg, TRT,
                                         pcfg)
    return logits, caches, cfg, params


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(jax_side, name):
    logits, _, _, _ = _prefill(name, jax_side)
    np.testing.assert_allclose(logits.numpy(), jax_side[f"{name}/prefill"],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_step_matches_jax(jax_side, name):
    _, caches, cfg, params = _prefill(name, jax_side)
    logits, _ = PL.pipeline_decode_step(
        params, torch.from_numpy(jax_side[f"{name}/tok"]), caches,
        torch.from_numpy(jax_side[f"{name}/cur"]), cfg, TRT, _pcfg())
    np.testing.assert_allclose(logits.numpy(), jax_side[f"{name}/step"],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_rounds_match_jax(jax_side, name):
    """R greedy rounds in one circular pass: JAX's rounds, or R sequential
    plain decodes, token for token."""
    _, caches, cfg, params = _prefill(name, jax_side)
    tok = torch.from_numpy(jax_side[f"{name}/tok"])
    outs, _ = PL.pipeline_decode_rounds(
        params, tok, caches, torch.from_numpy(jax_side[f"{name}/cur"]), cfg,
        TRT, _pcfg(), rounds=GEOMETRY["rounds"])
    assert outs.dtype == torch.int32
    np.testing.assert_array_equal(outs.numpy(), jax_side[f"{name}/rounds"])


def test_rounds_refuse_fewer_microbatches_than_stages():
    cfg, params = _port_setup("yi-9b", 4)
    pcfg = PL.PipelineConfig(n_stages=2, n_microbatches=1, mb_size=2)
    caches = PL.init_pipeline_caches(cfg, pcfg, 16, TRT, device="cpu")
    z = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="N_B >= N_S"):
        PL.pipeline_decode_rounds(params, z, caches, z, cfg, TRT, pcfg,
                                  rounds=2)


def test_caches_follow_the_stage_split():
    """Stage layers a microbatch of mb rows, epilogue layers over the
    global batch; the layer weights are the params' own tensors."""
    cfg, params = _port_setup("recurrentgemma-9b", 8)
    pcfg = _pcfg()
    caches = PL.init_pipeline_caches(cfg, pcfg, 16, TRT, device="cpu")
    stages, epi = PL.split_scan_params(params, cfg, pcfg.n_stages)
    assert [r for r, _ in stages] == [(0, 3), (3, 6)] and epi[0] == (6, 8)
    assert epi[1][0] is params["layers"][6]
    for mb in caches["stage"]:
        assert [c is None for c in mb["layers"]] == [False] * 6 + [True] * 2
        assert mb["layers"][0]["h"].shape[0] == pcfg.mb_size
    epilogue = caches["epilogue"]["layers"]
    assert [c is None for c in epilogue] == [True] * 6 + [False] * 2
    assert epilogue[6]["h"].shape[0] == pcfg.global_batch
    assert pcfg.n_ticks == pcfg.n_microbatches + pcfg.n_stages - 1


def test_rounds_write_the_epilogue_rows_in_place():
    """The rounds' epilogue writes reach the global-batch caches: after
    the pass every microbatch's rows of the rglru epilogue state differ
    from the prefill's."""
    out_cfg, params = _port_setup("recurrentgemma-9b", 8)
    pcfg = _pcfg()
    caches = PL.init_pipeline_caches(out_cfg, pcfg, GEOMETRY["cap"], TRT,
                                     device="cpu")
    rng = np.random.RandomState(5)
    toks = torch.from_numpy(rng.randint(
        1, out_cfg.vocab_size, (pcfg.n_microbatches, pcfg.mb_size,
                                GEOMETRY["seq"])).astype(np.int32))
    logits, caches = PL.pipeline_prefill(params, toks, caches, out_cfg, TRT,
                                         pcfg)
    before = caches["epilogue"]["layers"][7]["h"].clone()
    cur = torch.full((pcfg.n_microbatches, pcfg.mb_size), GEOMETRY["seq"],
                     dtype=torch.int32)
    PL.pipeline_decode_rounds(params, logits.argmax(-1).to(torch.int32),
                              caches, cur, out_cfg, TRT, pcfg, rounds=2)
    after = caches["epilogue"]["layers"][7]["h"]
    changed = (after != before).any(dim=-1)
    assert changed.all(), changed


def test_init_pipeline_caches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    cfg = reduced_config(get_arch("yi-9b"), num_layers=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.init_pipeline_caches(cfg, _pcfg(), 16, TRT)
