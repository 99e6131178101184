"""The port's audio and vision front ends (musicgen-large, qwen2-vl-2b)
against the JAX package's, on the same weights and inputs.

Weights come from ``repro.models.model.init_params`` and are carried
across with ``repro_torch.models.convert.from_jax_params``; inputs are
made with numpy from a seed.  Float32 on the CPU: positions exactly,
M-RoPE and logits within ``TOL`` (the two frameworks sum in other orders),
greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import list_archs as jax_list_archs  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.serving.kv_cache import PoolConfig as JaxPool  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.kv_cache import PoolConfig  # noqa: E402
from repro_torch.serving.request import SamplingParams  # noqa: E402

TOL = 1e-5
JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
FRONTEND_ARCHS = ("musicgen-large", "qwen2-vl-2b")


def configs(arch, **kw):
    return (dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw),
            dataclasses.replace(reduced_config(get_arch(arch)), **kw))


def weights(jcfg, tcfg, seed=0):
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(seed), JRT)
    return params, from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   TRT, device="cpu")


def inputs(cfg, rng, b, s, text_only=False):
    """numpy inputs of the arch's front end: frames (B, S, D), or tokens
    (B, S) after ``num_patch_tokens`` patches (B, P, D) scaled by 0.1 (the
    JAX package's test inputs), or tokens alone."""
    if cfg.frontend == "audio_frames":
        return {"frames": rng.randn(b, s, cfg.d_model).astype(np.float32)}
    out = {"tokens": rng.randint(1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches" and not text_only:
        out["patches"] = (0.1 * rng.randn(b, cfg.num_patch_tokens,
                                          cfg.d_model)).astype(np.float32)
    return out


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_get_arch_knows_all_eleven_archs():
    tconfig._load_all_configs()
    names = sorted(tconfig._REGISTRY)
    assert names == jax_list_archs()
    assert len(names) == 11
    for name in names:
        assert get_arch(name).name == name


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_front_end_configs_copy_the_jax_fields(arch):
    """Field for field, the published config and its reduced form (which
    keeps at most 4 patch tokens); ``param_count`` as the JAX package
    counts (the projections are not counted there)."""
    jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
    for full in (True, False):
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced_config(tcfg)
        want = dataclasses.asdict(jcfg)
        got = dataclasses.asdict(tcfg)
        assert {k: got[k] for k in got} == {k: want[k] for k in got}
        assert tcfg.param_count() == jcfg.param_count()
    assert get_arch("qwen2-vl-2b").num_patch_tokens == 256
    assert reduced_config(get_arch("qwen2-vl-2b")).num_patch_tokens == 4


@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_apply_mrope_matches_jax(head_dim):
    """Patch positions (t = 0 on a raster) then text positions, through
    both packages' M-RoPE; and text positions alone rotate exactly as
    plain RoPE does."""
    rng = np.random.RandomState(head_dim)
    b, p, st, h = 2, 9, 7, 3
    x = rng.randn(b, p + st, h, head_dim).astype(np.float32)
    jpos = jnp.concatenate([
        jax_common.patch_positions3(b, p),
        jax_common.text_positions3(jnp.broadcast_to(3 + jnp.arange(st)[None],
                                                    (b, st)))], axis=2)
    tpos = torch.cat([
        tcommon.patch_positions3(b, p),
        tcommon.text_positions3((3 + torch.arange(st))[None].expand(b, st))],
        dim=2)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    want = jax_common.apply_mrope(jnp.asarray(x), jpos, 1e6)
    got = tcommon.apply_mrope(torch.from_numpy(x), tpos, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # qwen2-vl's (16, 24, 24) pairs, scaled to Dh / 2 pairs
    want_sections = {16: [2, 3, 3], 64: [8, 12, 12], 128: [16, 24, 24]}
    assert np.bincount(tcommon.mrope_components(head_dim)).tolist() == \
        want_sections[head_dim]
    text = torch.arange(st)[None].expand(b, st)
    xt = torch.from_numpy(x[:, :st])
    assert torch.equal(tcommon.apply_mrope(xt, tcommon.text_positions3(text),
                                           1e6),
                       tcommon.apply_rope(xt, text, 1e6))


@pytest.mark.parametrize("arch,text_only", [("musicgen-large", False),
                                            ("qwen2-vl-2b", False),
                                            ("qwen2-vl-2b", True),
                                            ("yi-9b", False)])
def test_embed_inputs_matches_jax(arch, text_only):
    """The residual stream and the positions ``embed_inputs`` builds: the
    frames projected, or the patches (t = 0, on a square raster) before
    the text, which starts at t = int(sqrt(P)); positions exactly."""
    jcfg, tcfg = configs(arch)
    jparams, tparams = weights(jcfg, tcfg)
    x_in = inputs(jcfg, np.random.RandomState(3), 2, 6, text_only)
    jx, jpos = jax_model.embed_inputs(jparams, _j(x_in), jcfg, JRT,
                                      mode="train")
    tx, tpos = tmodel.embed_inputs(tparams, _t(x_in), tcfg, TRT)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL,
                               atol=TOL)
    if arch == "qwen2-vl-2b" and not text_only:
        p = tcfg.num_patch_tokens
        assert tpos.shape == (3, 2, p + 6)
        assert (tpos[0, :, :p] == 0).all()
        assert tpos[0, 0, p:].tolist() == list(range(2, 8))  # side = 2


def jax_prefill_decode(jcfg, jparams, x_in, cap, start, steps):
    logits, caches = jax_model.prefill(jparams, _j(x_in), jcfg, JRT, cap)
    out = [np.asarray(logits)]
    for i in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, caches = jax_model.decode_step(
            jparams, tok, caches, jnp.full((tok.shape[0],), start + i,
                                           jnp.int32), jcfg, JRT)
        out.append(np.asarray(logits))
    return out


def port_prefill_decode(tcfg, tparams, x_in, cap, start, steps):
    logits, caches = tmodel.prefill(tparams, _t(x_in), tcfg, TRT, cap)
    out = [logits.numpy()]
    for i in range(steps):
        tok = logits.argmax(-1)
        logits, caches = tmodel.decode_step(
            tparams, tok, caches, torch.full((tok.shape[0],), start + i),
            tcfg, TRT)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("arch,text_only", [("musicgen-large", False),
                                            ("qwen2-vl-2b", False),
                                            ("qwen2-vl-2b", True)])
def test_prefill_then_decode_match_jax(arch, text_only):
    """``prefill({"frames"})`` / ``prefill({"tokens", "patches"})`` /
    ``prefill({"tokens"})`` into dense caches, then four greedy decode
    steps from S (+ P for the patches, as the JAX package's test decodes):
    logits within ``TOL`` at every step, greedy tokens equal."""
    jcfg, tcfg = configs(arch)
    jparams, tparams = weights(jcfg, tcfg)
    s = 10
    x_in = inputs(jcfg, np.random.RandomState(4), 2, s, text_only)
    start = s + (jcfg.num_patch_tokens if "patches" in x_in else 0)
    cap = start + 8
    want = jax_prefill_decode(jcfg, jparams, x_in, cap, start, 4)
    got = port_prefill_decode(tcfg, tparams, x_in, cap, start, 4)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
        assert (g.argmax(-1) == w.argmax(-1)).all(), f"step {i}"


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_paged_decode_after_front_end_prefill_matches_jax(arch):
    """The decode the serving engine runs, through paged pools (the paged
    kernel's plain version here): a front-end prefill's dense caches
    copied into pools of 4-token pages, row r's slot i at page
    ``table[r, i // 4]``, then four greedy decode steps from S (+ P); the
    logits within ``TOL`` of JAX's dense decode at every step."""
    from repro_torch.serving import kv_cache as kvc
    jcfg, tcfg = configs(arch)
    jparams, tparams = weights(jcfg, tcfg)
    b, s, page = 2, 10, 4
    x_in = inputs(jcfg, np.random.RandomState(6), b, s)
    start = s + (jcfg.num_patch_tokens if "patches" in x_in else 0)
    cap = start + 8
    want = jax_prefill_decode(jcfg, jparams, x_in, cap, start, 4)
    logits, dense = tmodel.prefill(tparams, _t(x_in), tcfg, TRT, cap)
    per_row = -(-cap // page)
    pool = PoolConfig(page_size=page, n_local_pages=b * per_row + 1,
                      max_pages_per_seq=per_row)
    table = 1 + np.arange(b * per_row, dtype=np.int32).reshape(b, per_row)
    caches = kvc.set_page_table(kvc.build_paged_caches(
        tcfg, b, pool, TRT, "cpu"), table)
    rows = torch.from_numpy(table).long()
    for src, dst in zip(dense["layers"], caches["layers"]):
        for name in ("k", "v"):
            t = torch.nn.functional.pad(
                src[name], (0, 0, 0, 0, 0, per_row * page - cap))
            dst[f"{name}_pages"][rows] = t.reshape(b, per_row, page,
                                                   *t.shape[2:])
    got = [logits.numpy()]
    for i in range(4):
        logits, caches = tmodel.decode_step(
            tparams, torch.from_numpy(want[i].argmax(-1)), caches,
            torch.full((b,), start + i), tcfg, TRT)
        got.append(logits.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")


def test_reference_decode_rotary_position_jumps_after_patches():
    """Pins the reference's vision decode, which the port mirrors: the
    text of a ``{"tokens", "patches"}`` prefill sits at rotary positions
    ``sqrt(P) .. sqrt(P) + S - 1``, but the next token decodes at ``cur_pos
    = S + P`` (the cache slot after the P + S prefilled ones), and
    ``decode_step`` rotates by ``cur_pos`` too: the rotary position jumps
    by ``P - sqrt(P) + 1``, not 1.  Decoding at ``sqrt(P) + S`` (the
    position after the text) gives other logits in both packages
    alike."""
    jcfg, tcfg = configs("qwen2-vl-2b", num_patch_tokens=9)
    jparams, tparams = weights(jcfg, tcfg)
    s, p = 6, 9
    x_in = inputs(jcfg, np.random.RandomState(5), 2, s)
    _, tpos = tmodel.embed_inputs(tparams, _t(x_in), tcfg, TRT)
    assert int(tpos[0].max()) == 3 + s - 1          # sqrt(P) + S - 1
    for start in (s + p, 3 + s):
        want = jax_prefill_decode(jcfg, jparams, x_in, s + p + 4, start, 1)
        got = port_prefill_decode(tcfg, tparams, x_in, s + p + 4, start, 1)
        np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
        if start == s + p:
            at_slot = got[1]
    assert not np.allclose(got[1], at_slot, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_front_end_weights_convert_and_init_alike(arch):
    """``frame_proj`` / ``patch_proj`` are carried across by value and
    made by ``init_params`` with the JAX shape and dtype, drawn after the
    token table and before the untied unembedding."""
    jcfg, tcfg = configs(arch)
    jparams, tparams = weights(jcfg, tcfg)
    name = "frame_proj" if arch == "musicgen-large" else "patch_proj"
    np.testing.assert_array_equal(tparams["embed"][name].numpy(),
                                  np.asarray(jparams["embed"][name]))
    made = tmodel.init_params(tcfg, 0, TRT, device="cpu")
    assert sorted(made["embed"]) == sorted(jparams["embed"])
    assert made["embed"][name].shape == (tcfg.d_model, tcfg.d_model)
    assert made["embed"][name].dtype == torch.float32


POOL = dict(page_size=8, n_local_pages=64, max_pages_per_seq=16)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_front_end_archs_serve_like_jax(arch):
    """Through ``LLM.generate`` both archs are token archs on the chunked,
    paged path (the JAX engine never reads frames or patches): the greedy
    streams equal the JAX engine's token for token, qwen2-vl's decode at
    text M-RoPE positions."""
    jcfg, tcfg = configs(arch)
    jparams, tparams = weights(jcfg, tcfg)
    rng = np.random.RandomState(6)
    prompts = [list(rng.randint(1, tcfg.vocab_size, n)) for n in (40, 7, 21)]
    want = jax_llm.LLM(jcfg, config=jax_llm.EngineConfig(
        mb_size=2, num_microbatches=2, pool=JaxPool(**POOL)),
        params=jparams, rt=JRT).generate(
        prompts, [JaxSP(temperature=0.0, max_new_tokens=6)] * 3)
    port = llm.LLM(tcfg, config=llm.EngineConfig(
        mb_size=2, num_microbatches=2, pool=PoolConfig(**POOL)),
        params=tparams, rt=TRT, device="cpu")
    assert port.engine.chunked_prefill
    got = port.generate(prompts, [SamplingParams(temperature=0.0,
                                                 max_new_tokens=6)] * 3)
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
