"""The port's decoder (``repro_torch.models.model``) against the JAX
package's (``repro.models.model``) on the same weights and inputs.

Weights come from ``repro.models.model.init_params`` and are carried
across with ``repro_torch.models.convert.from_jax_params``.  Both sides run
in float32 on the CPU; logits agree within ``1e-4`` (the two frameworks
sum matmuls, softmaxes and RoPE angles in another order, and on the
Pallas route the kernel sums per block of pages).  The ``head_dim=64``
variant sends the JAX side through the Pallas paged kernel (interpret
mode) and the port through its plain paged attention.  The gemma3 tests
run the exact-length ``prefill`` and the dense / ring ``decode_step`` of
the sliding-window archs, with float32 and int8 caches.
"""

import dataclasses

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
from repro.serving import kv_cache as jax_kv  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
# reduced yi-9b (head_dim 16: the JAX router takes its jnp reference), and
# 8 heads over 2 KV heads at head_dim 64 (the JAX router takes Pallas)
VARIANTS = {"reduced": {},
            "hd64": dict(num_heads=8, num_kv_heads=2, head_dim=64)}


def configs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_reduced(jax_get_arch("yi-9b")), **kw),
            dataclasses.replace(reduced_config(get_arch("yi-9b")), **kw))


def weights(jcfg, tcfg, seed=0):
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(seed), JRT)
    return params, from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   TRT, device="cpu")


POOL = dict(page_size=8, n_local_pages=16, max_pages_per_seq=4)


def jax_pools(jcfg, table):
    pool = jax_kv.PoolConfig(**POOL)
    caches = jax_kv.build_paged_caches(jcfg, table.shape[0], pool, JRT)
    return jax_kv.set_page_table(caches, table)


def torch_pools(tcfg, table):
    pool = tkv.PoolConfig(**POOL)
    caches = tkv.build_paged_caches(tcfg, table.shape[0], pool, TRT,
                                    device="cpu")
    return tkv.set_page_table(caches, table)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_chunks_then_decode_match_jax(variant):
    chunks_then_decode(*configs(variant), TOL)


def chunks_then_decode(jcfg, tcfg, tol):
    """Two prefill chunks of two rows into the paged pools, then three
    greedy decode steps: logits and pools against the JAX model."""
    jparams, tparams = weights(jcfg, tcfg)
    TOL = tol
    rng = np.random.RandomState(0)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jc, tc = jax_pools(jcfg, table), torch_pools(tcfg, table)
    prompts = [rng.randint(1, jcfg.vocab_size, 13), rng.randint(1, 50, 5)]
    C = 8
    offsets = np.zeros(2, np.int32)
    logits = {}
    # two chunks: row 0 takes 8 then 5 tokens; row 1 takes 5 (3 pad
    # positions), then sits out the second chunk as a padding row
    for step in range(2):
        tokens = np.zeros((2, C), np.int32)
        n_valid = np.zeros(2, np.int32)
        lasts = np.full(2, -1, np.int32)
        for r, p in enumerate(prompts):
            take = max(0, min(C, len(p) - offsets[r]))
            tokens[r, :take] = p[offsets[r]:offsets[r] + take]
            n_valid[r] = take
            if take and offsets[r] + take == len(p):
                lasts[r] = take - 1
        jl, jc = jax_model.prefill_chunk(
            jparams, jnp.asarray(tokens), jc, jnp.asarray(offsets),
            jnp.asarray(n_valid), jnp.asarray(lasts), jcfg, JRT)
        tl, tc = tmodel.prefill_chunk(
            tparams, _t(tokens), tc, _t(offsets), _t(n_valid), _t(lasts),
            tcfg, TRT)
        for r in range(2):
            if lasts[r] >= 0:
                np.testing.assert_allclose(tl[r].numpy(), np.asarray(jl[r]),
                                           rtol=TOL, atol=TOL)
                logits[r] = tl[r]
        offsets += n_valid
    # the pools the two sides wrote agree where rows own pages
    for i, layer in enumerate(tc["layers"]):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(
                layer[name][1:9].numpy(),
                np.asarray(jc["scan"][0][name][i][1:9]), rtol=TOL, atol=TOL)
    # three decode steps, greedy, from the prefill logits
    cur = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.asarray([int(logits[r].argmax()) for r in range(2)], np.int32)
    for _ in range(3):
        jl, jc = jax_model.decode_step(jparams, jnp.asarray(toks), jc,
                                       jnp.asarray(cur), jcfg, JRT)
        tl, tc = tmodel.decode_step(tparams, _t(toks), tc, _t(cur), tcfg, TRT)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        toks = np.asarray(tl.argmax(-1), np.int32)
        assert (toks == np.asarray(jnp.argmax(jl, -1))).all()
        cur = cur + 1


def test_pad_positions_drop_their_kv_writes():
    """Positions marked -1 write nothing: every pool entry other than the
    valid positions' (page, offset) keeps its value bit for bit."""
    jcfg, tcfg = configs("reduced")
    _, tparams = weights(jcfg, tcfg)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    tc = torch_pools(tcfg, table)
    gen = torch.Generator().manual_seed(0)
    for layer in tc["layers"]:
        for name in ("k_pages", "v_pages"):
            layer[name].copy_(torch.randn(layer[name].shape, generator=gen))
    before = [{n: t.clone() for n, t in layer.items()}
              for layer in tc["layers"]]
    tokens = torch.randint(1, tcfg.vocab_size, (3, 8), generator=gen)
    offsets = torch.tensor([3, 10, 0], dtype=torch.int32)
    n_valid = torch.tensor([2, 8, 0], dtype=torch.int32)   # row 2: all pad
    lasts = torch.tensor([1, -1, -1], dtype=torch.int32)
    tmodel.prefill_chunk(tparams, tokens, tc, offsets, n_valid, lasts, tcfg,
                         TRT)
    written = {(1, 3), (1, 4)} | {(5 + p // 8, p % 8) for p in range(10, 18)}
    for layer, old in zip(tc["layers"], before):
        for name in ("k_pages", "v_pages"):
            changed = (layer[name] != old[name]).flatten(2).any(-1)
            got = {tuple(ix) for ix in changed.nonzero().tolist()}
            assert got == written, name


def test_unported_layer_kinds_raise():
    """Every layer kind is ported: patterns mixing the xLSTM kinds with the
    others build weights and caches.  What the port still refuses is what
    the reference refuses: a chunked prefill through a recurrent layer."""
    base = reduced_config(get_arch("yi-9b"))
    for kinds in (("mlstm", "slstm"), ("rglru", "mlstm"), ("slstm", "attn")):
        cfg = dataclasses.replace(base, block_pattern=kinds, d_ff=0)
        params = tmodel.init_params(cfg, 0, TRT, device="cpu")
        caches = tmodel.init_caches(cfg, 1, 8, TRT, device="cpu")
        assert len(params["layers"]) == len(caches["layers"]) == \
            cfg.num_layers
        tokens = torch.ones((1, 4), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="recurrent"):
            tmodel.run_layers(params, torch.zeros((1, 4, cfg.d_model)), cfg,
                              TRT, mode="chunk", caches=caches,
                              positions=torch.arange(4)[None])
        tmodel.prefill(params, {"tokens": tokens}, cfg, TRT, 8,
                       caches=caches)


@pytest.mark.parametrize("window", [0, 5])
def test_plain_attention_matches_jax(window):
    """``chunk_attention`` and ``decode_attention`` against
    ``repro.models.attention`` on the same random inputs (float32, 1e-5:
    only the summation order differs)."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as tattn
    rng = np.random.RandomState(window)
    b, c, t, h, hk, dh = 2, 4, 12, 8, 2, 16
    q = rng.randn(b, c, h, dh).astype(np.float32)
    k = rng.randn(b, t, hk, dh).astype(np.float32)
    v = rng.randn(b, t, hk, dh).astype(np.float32)
    q_pos = np.asarray([[6, 7, 8, 9], [0, 1, -1, -1]], np.int32)
    want = jax_attn.chunk_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.arange(t),
                                    jnp.asarray(q_pos), window=window)
    got = tattn.chunk_attention(_t(q), _t(k), _t(v), torch.arange(t),
                                _t(q_pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    slot_pos = np.where(np.arange(t)[None] < [[9], [12]], np.arange(t),
                        -1).astype(np.int32)
    cur = np.asarray([8, 11], np.int32)
    want = jax_attn.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(slot_pos),
                                     jnp.asarray(cur), window=window)
    got = tattn.decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(slot_pos),
                                 _t(cur), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rope_and_rms_norm_match_jax():
    """RoPE rotates split halves with float64 frequencies cast to float32;
    RMSNorm scales by ``1 + w``.  Both against ``repro.models.common``."""
    from repro.models import common as jax_common
    from repro_torch.models import common as tcommon
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 4, 64).astype(np.float32)
    pos = rng.randint(0, 4000, (2, 5)).astype(np.int32)
    want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)
    got = tcommon.apply_rope(_t(x), _t(pos), 5e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    w = (0.1 * rng.randn(64)).astype(np.float32)
    want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tcommon.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# exact-length prefill, dense and ring caches (gemma3)
# ---------------------------------------------------------------------------


def gemma_configs(arch, **kw):
    return (dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw),
            dataclasses.replace(reduced_config(get_arch(arch)), **kw))


def jax_layer_caches(jc, cfg):
    """The JAX cache tree as the port's per-layer list: scan leaves are
    stacked over periods, layer order is period by period, then the
    tail."""
    period = len(cfg.block_pattern)
    n_periods = cfg.num_layers // period
    layers = [{k: np.asarray(a[p]) for k, a in jc["scan"][i].items()}
              for p in range(n_periods) for i in range(period)]
    layers += [{k: np.asarray(a) for k, a in c.items()} for c in jc["tail"]]
    return layers


# jitted JAX entry points: op-by-op dispatch of a scanned model is slower
# on the CPU than one compile
jax_prefill = jax.jit(jax_model.prefill, static_argnums=(2, 3, 4))
jax_decode = jax.jit(jax_model.decode_step, static_argnums=(4, 5))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-12b"])
def test_exact_prefill_then_ring_decode_match_jax(arch, kv_dtype):
    """``prefill`` over dense caches (rings of ``window`` slots for the
    local layers), prompts longer than the window, one row right-padded,
    then decode steps that wrap the rings; logits and caches against
    ``repro.models.model.prefill`` / ``decode_step``."""
    jcfg, tcfg = gemma_configs(arch)
    jrt, trt = JRT.replace(kv_dtype=kv_dtype), \
        dataclasses.replace(TRT, kv_dtype=kv_dtype)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(1), jrt)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, trt,
                              device="cpu")
    rng = np.random.RandomState(2)
    S, cap = 40, 64                         # window 32 < S < capacity
    tokens = rng.randint(1, jcfg.vocab_size, (2, S)).astype(np.int32)
    last = np.asarray([S - 1, 33], np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jrt,
                         cap, last_index=jnp.asarray(last))
    tl, tc = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, trt, cap,
                            last_index=_t(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for kind, want, got in zip(tcfg.layer_kinds(),
                               jax_layer_caches(jc, jcfg), tc["layers"]):
        assert got["k"].shape[1] == (32 if kind == "local" else cap)
        np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
        if kv_dtype == "int8":
            # the same int8 values; the bf16 scales round float32 maxima
            # that may differ in their last bits: one bf16 ulp (2**-7)
            np.testing.assert_array_equal(got["k"].numpy(), want["k"])
            np.testing.assert_allclose(_np(got["k_scale"]),
                                       want["k_scale"].astype(np.float32),
                                       rtol=2 ** -7)
        else:
            np.testing.assert_allclose(got["k"].numpy(), want["k"],
                                       rtol=TOL, atol=TOL)
    cur = last + 1
    toks = np.asarray(tl.argmax(-1), np.int32)
    for _ in range(4):
        jl, jc = jax_decode(jparams, jnp.asarray(toks), jc, jnp.asarray(cur),
                            jcfg, jrt)
        tl, tc = tmodel.decode_step(tparams, _t(toks), tc, _t(cur), tcfg,
                                    trt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        toks = np.asarray(tl.argmax(-1), np.int32)
        cur = cur + 1
    for want, got in zip(jax_layer_caches(jc, jcfg), tc["layers"]):
        np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])


def test_padded_ring_prefill_keeps_the_reference_behaviour():
    """A ring of 8 slots, a prompt of 13 tokens padded to 16: both packages
    keep the last 8 slots of the *padded* sequence, so the ring holds
    positions 8..12 and three empty slots, and the in-window positions 6
    and 7 are never written (a defect of the reference that the port
    reproduces for parity)."""
    jcfg, tcfg = gemma_configs("gemma3-1b", window_size=8)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    tokens = np.random.RandomState(3).randint(
        1, jcfg.vocab_size, (1, 16)).astype(np.int32)
    last = np.asarray([12], np.int32)
    _, jc = jax_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, JRT,
                        64, last_index=jnp.asarray(last))
    _, tc = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, TRT, 64,
                           last_index=_t(last))
    ring = [8, 9, 10, 11, 12, -1, -1, -1]
    for kind, want, got in zip(tcfg.layer_kinds(),
                               jax_layer_caches(jc, jcfg), tc["layers"]):
        if kind == "local":
            assert want["pos"][0].tolist() == ring
            assert got["pos"][0].tolist() == ring
        else:
            assert got["pos"][0, :16].tolist() == list(range(13)) + [-1] * 3


def test_int8_quantization_matches_jax():
    """``_quantize_kv`` / ``_dequant_kv`` bit for bit, ties included (both
    round half to even)."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 2, 16).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]     # scale 1: exact .5 ties
    jq, js = jax_model._quantize_kv(jnp.asarray(x))
    tq, ts = tmodel._quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js, np.float32))
    assert tq[0, 0, 0, :4].tolist() == [127, 0, 2, -2]
    jk, _ = jax_model._dequant_kv({"k": jq, "v": jq, "k_scale": js,
                                   "v_scale": js}, jnp.float32)
    tk, _ = tmodel._dequant_kv({"k": tq, "v": tq, "k_scale": ts,
                                "v_scale": ts}, torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_engine_caches_put_local_layers_on_rings():
    """``build_paged_caches``: paged pools for the global layers, rings of
    ``window_size`` slots (positions -1) for the local ones, as
    ``repro.serving.kv_cache.build_paged_caches``; ``reset_slot`` empties
    one row of every ring."""
    jcfg, tcfg = gemma_configs("gemma3-1b")
    table = np.zeros((3, 4), np.int32)
    jc = jax_layer_caches(jax_pools(jcfg, table), jcfg)
    tc = torch_pools(tcfg, table)
    for kind, want, got in zip(tcfg.layer_kinds(), jc, tc["layers"]):
        assert sorted(got) == sorted(k for k in want if k != "page_table")
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, (kind, name)
        if kind == "local":
            assert (got["pos"] == -1).all()
            got["pos"].fill_(5)
    tkv.reset_slot(tc, 1)
    for kind, got in zip(tcfg.layer_kinds(), tc["layers"]):
        if kind == "local":
            assert (got["pos"][1] == -1).all() and (got["pos"][0] == 5).all()


# ---------------------------------------------------------------------------
# the Griffin recurrent block (recurrentgemma)
# ---------------------------------------------------------------------------


def test_recurrentgemma_prefill_then_decode_match_jax():
    """Reduced recurrentgemma ``(rglru, rglru, local, rglru)``, window 32:
    an exact prefill of 40 tokens (past the window), the same prompts
    right-padded with ``last_index`` (row 1 has 29 real tokens), then four
    decode steps; logits, recurrent states and rings against
    ``repro.models.model.prefill`` / ``decode_step``."""
    jcfg, tcfg = gemma_configs("recurrentgemma-9b")
    assert tcfg.layer_kinds() == ("rglru", "rglru", "local", "rglru")
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(2), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    rng = np.random.RandomState(5)
    S, cap = 40, 64
    tokens = rng.randint(1, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, _ = jax_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, JRT,
                        cap)
    tl, _ = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, TRT, cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)

    last = np.asarray([S - 1, 28], np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, JRT,
                         cap, last_index=jnp.asarray(last))
    tl, tc = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, TRT, cap,
                            last_index=_t(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)

    def check_caches():
        for kind, want, got in zip(tcfg.layer_kinds(),
                                   jax_layer_caches(jc, jcfg), tc["layers"]):
            assert sorted(got) == sorted(want), kind
            if kind == "rglru":
                assert got["h"].dtype == torch.float32
                for name in ("h", "conv"):
                    np.testing.assert_allclose(got[name].numpy(), want[name],
                                               rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(got["pos"].numpy(),
                                              want["pos"])

    check_caches()
    cur = last + 1
    toks = np.asarray(tl.argmax(-1), np.int32)
    for _ in range(4):
        jl, jc = jax_decode(jparams, jnp.asarray(toks), jc, jnp.asarray(cur),
                            jcfg, JRT)
        tl, tc = tmodel.decode_step(tparams, _t(toks), tc, _t(cur), tcfg,
                                    TRT)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        toks = np.asarray(tl.argmax(-1), np.int32)
        cur = cur + 1
    check_caches()


def test_padded_prefill_carries_the_exact_recurrent_state():
    """A prompt padded past its end leaves every recurrent state and the
    last logits as the unpadded prompt does: pad steps are identities of
    the recurrence and the conv keeps the window of the last real inputs.
    Within 1e-6, not bit for bit: the projections are matmuls of another
    length, which the CPU's BLAS blocks and sums differently."""
    _, tcfg = gemma_configs("recurrentgemma-9b")
    tparams = tmodel.init_params(tcfg, 3, TRT, device="cpu")
    tokens = torch.randint(1, tcfg.vocab_size, (1, 13),
                           generator=torch.Generator().manual_seed(0))
    padded = torch.cat([tokens, torch.zeros((1, 3), dtype=tokens.dtype)], 1)
    want, wc = tmodel.prefill(tparams, {"tokens": tokens}, tcfg, TRT, 64)
    got, gc = tmodel.prefill(tparams, {"tokens": padded}, tcfg, TRT, 64,
                             last_index=torch.tensor([12]))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for kind, w, g in zip(tcfg.layer_kinds(), wc["layers"], gc["layers"]):
        if kind == "rglru":
            torch.testing.assert_close(g["h"], w["h"], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(g["conv"], w["conv"], rtol=1e-6,
                                       atol=1e-6)


def test_from_jax_params_keeps_float32_leaves_under_bf16():
    """``gate_a_b``, ``gate_x_b`` and ``lam`` stay float32 with bf16
    parameters, as in the JAX package; ``init_params`` makes them so too."""
    jcfg, tcfg = gemma_configs("recurrentgemma-9b")
    jrt = JaxRuntime(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    trt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), jrt)
    converted = from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg, trt,
        device="cpu")
    made = tmodel.init_params(tcfg, 0, trt, device="cpu")
    jlayers = jax_layer_caches(jparams, jcfg)
    for kind, jw, cw, mw in zip(tcfg.layer_kinds(), jlayers,
                                converted["layers"], made["layers"]):
        assert sorted(cw) == sorted(mw) == sorted(jw), kind
        for name, t in cw.items():
            want = torch.float32 if jw[name].dtype == np.float32 else \
                torch.bfloat16
            assert t.dtype == mw[name].dtype == want, (kind, name)
            assert tuple(t.shape) == tuple(mw[name].shape) == jw[name].shape
        if kind == "rglru":
            assert {n for n, t in cw.items() if t.dtype == torch.float32} \
                == set(tmodel.FLOAT32_LEAVES["rglru"])
            np.testing.assert_array_equal(mw["lam"].numpy(), jw["lam"])


def test_engine_caches_hold_recurrent_states_and_reset_them():
    """``build_paged_caches`` for recurrentgemma: a state ``h`` (float32)
    and ``conv`` per row for each rglru layer, a ring for the local one, no
    pool, and the page table; ``reset_slot`` zeros one row of every state,
    as ``repro.serving.kv_cache.reset_slot`` does."""
    jcfg, tcfg = gemma_configs("recurrentgemma-9b")
    table = np.zeros((3, 4), np.int32)
    jc = jax_layer_caches(jax_pools(jcfg, table), jcfg)
    tc = torch_pools(tcfg, table)
    assert tuple(tc["page_table"].shape) == (3, 4)
    for kind, want, got in zip(tcfg.layer_kinds(), jc, tc["layers"]):
        assert sorted(got) == sorted(k for k in want if k != "page_table")
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, (kind, name)
        if kind == "rglru":
            got["h"].fill_(2.0)
            got["conv"].fill_(3.0)
    view = tkv.slot_view(tc, 1, 1)
    tkv.reset_slot(tc, 1)
    for kind, got, v in zip(tcfg.layer_kinds(), tc["layers"],
                            view["layers"]):
        if kind == "rglru":
            assert (got["h"][1] == 0).all() and (got["conv"][1] == 0).all()
            assert (got["h"][0] == 2).all() and (got["conv"][2] == 3).all()
            assert v["h"].data_ptr() == got["h"][1:2].data_ptr()


def test_entry_points_default_to_the_card():
    """``init_params``, ``init_caches``, ``build_paged_caches`` and
    ``from_jax_params`` run on ``cuda`` unless the caller asks for another
    device: with no card and no ``device`` they raise, never quietly
    computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default resolves to it")
    jcfg, tcfg = jax_reduced(jax_get_arch("yi-9b")), \
        reduced_config(get_arch("yi-9b"))
    np_tree = jax.tree.map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(0), JRT))
    calls = [lambda: tmodel.init_params(tcfg, 0, TRT),
             lambda: tmodel.init_caches(tcfg, 2, 16, TRT),
             lambda: tkv.build_paged_caches(tcfg, 2, tkv.PoolConfig(**POOL),
                                            TRT),
             lambda: from_jax_params(np_tree, tcfg, TRT)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # and the same calls with device="cpu" build on the CPU
    assert tmodel.init_caches(tcfg, 2, 16, TRT, device="cpu")["layers"][0][
        "k"].device.type == "cpu"
    assert from_jax_params(np_tree, tcfg, TRT, device="cpu")[
        "final_norm"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the other architectures: MoE, xLSTM, the dense llama3-70b and minitron-4b
# ---------------------------------------------------------------------------

# the archs this slice adds, each through reduced_config
PAGED_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "minitron-4b",
               "llama3-70b")
NEW_ARCHS = PAGED_ARCHS + ("xlstm-1.3b",)
# xlstm's logits and states within 5e-2: ``h = num / den`` magnifies a
# float32 rounding difference where ``den`` is small, and each of the 12
# residual blocks of the random-init model multiplies it again, about
# threefold (the blocks alone agree within 1e-4, tests/test_torch_xlstm.py).
# The growth is the model's, not either package's: on this test's prefill
# the port in float64 lies 1.2e-2 from the port in float32 and 2.4e-2 from
# the JAX package in float32
XLSTM_TOL = 5e-2


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_other_archs_prefill_chunks_then_decode_match_jax(arch):
    """The MoE FFN (every row of a call routed, padding included) and the
    dense configs through the chunked prefill and paged decode."""
    chunks_then_decode(*gemma_configs(arch), TOL)


def test_xlstm_prefill_then_decode_match_jax():
    """Reduced xlstm-1.3b (7 mLSTM + 1 sLSTM, then a 4-layer tail): an
    exact prefill of 40 tokens in mLSTM chunks of 16 (a ragged third
    chunk), one row right-padded to 29 real tokens, then four decode
    steps; logits and every recurrent state against the JAX model, and
    the greedy tokens equal."""
    jcfg, tcfg = gemma_configs("xlstm-1.3b")
    assert tcfg.layer_kinds() == ("mlstm",) * 7 + ("slstm",) + \
        ("mlstm",) * 4
    jrt = JRT.replace(mlstm_chunk=16)
    trt = dataclasses.replace(TRT, mlstm_chunk=16)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(2), jrt)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, trt,
                              device="cpu")
    rng = np.random.RandomState(5)
    S = 40
    tokens = rng.randint(1, jcfg.vocab_size, (2, S)).astype(np.int32)
    last = np.asarray([S - 1, 28], np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jrt,
                         S, last_index=jnp.asarray(last))
    tl, tc = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, trt, S,
                            last_index=_t(last))
    tol = XLSTM_TOL

    def check():
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
        for kind, want, got in zip(tcfg.layer_kinds(),
                                   jax_layer_caches(jc, jcfg), tc["layers"]):
            assert sorted(got) == sorted(want), kind
            for name, t in got.items():
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), want[name], rtol=tol,
                                           atol=tol, err_msg=f"{kind} {name}")

    check()
    cur = last + 1
    toks = np.asarray(tl.argmax(-1), np.int32)
    for _ in range(4):
        jl, jc = jax_decode(jparams, jnp.asarray(toks), jc, jnp.asarray(cur),
                            jcfg, jrt)
        tl, tc = tmodel.decode_step(tparams, _t(toks), tc, _t(cur), tcfg,
                                    trt)
        check()
        assert (tl.argmax(-1).numpy() == np.asarray(jnp.argmax(jl, -1))).all()
        toks = np.asarray(tl.argmax(-1), np.int32)
        cur = cur + 1


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_xlstm_model_gap_is_the_random_inits_amplification(factor):
    """The check behind ``XLSTM_TOL``: the same prefill with the mLSTM /
    sLSTM matrices (``wm, wz, wq, wk, wv, wo, w_in, r``) of the converted
    JAX weights scaled by ``factor``, in both packages alike.  At 1.0 the
    random init lets each block multiply a float32 rounding difference,
    and the logits end up about 1e-2 apart; at 0.5 the recurrence
    contracts and the whole model agrees within ``TOL``, as each block
    alone does: the gap is the init's, not a port fault."""
    jcfg, tcfg = gemma_configs("xlstm-1.3b")
    jrt = JRT.replace(mlstm_chunk=16)
    trt = dataclasses.replace(TRT, mlstm_chunk=16)
    names = ("wm", "wz", "wq", "wk", "wv", "wo", "w_in", "r")
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, a: a * factor if getattr(p[-1], "key", None) in names
        else a, jax_model.init_params(jcfg, jax.random.PRNGKey(2), jrt))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, trt,
                              device="cpu")
    tokens = np.random.RandomState(5).randint(
        1, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jax_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jrt,
                        40)
    tl, _ = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, trt, 40)
    gap = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    if factor == 1.0:
        assert TOL < gap <= XLSTM_TOL
    else:
        assert gap <= TOL


@pytest.mark.parametrize("reduced", [False, True])
def test_param_counts_match_jax(reduced):
    """``param_count`` and ``active_param_count`` of every arch the port
    registers equal ``repro.config``'s, at full size and reduced."""
    from repro_torch import config as tconfig
    tconfig._load_all_configs()
    names = sorted(tconfig._REGISTRY)
    assert set(NEW_ARCHS) <= set(names)
    for name in names:
        jcfg, tcfg = jax_get_arch(name), get_arch(name)
        if reduced:
            jcfg, tcfg = jax_reduced(jcfg), reduced_config(tcfg)
            assert (tcfg.moe is None) == (jcfg.moe is None)
            if tcfg.moe is not None:
                assert dataclasses.asdict(tcfg.moe) == \
                    dataclasses.asdict(jcfg.moe)
        assert tcfg.param_count() == jcfg.param_count(), name
        assert tcfg.active_param_count() == jcfg.active_param_count(), name
        assert tcfg.num_layers_with_moe() == jcfg.num_layers_with_moe()
    phi = get_arch("phi3.5-moe-42b-a6.6b")
    assert phi.active_param_count() < phi.param_count()


def test_shape_and_mesh_tables_match_jax():
    """``SHAPES``, ``SINGLE_POD`` / ``MULTI_POD`` and ``list_archs`` are the
    JAX package's, value for value."""
    from repro import config as jconfig
    from repro_torch import config as tconfig
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    for name, s in tconfig.SHAPES.items():
        assert s.tokens_per_step == jconfig.SHAPES[name].tokens_per_step
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        t, j = getattr(tconfig, mesh), getattr(jconfig, mesh)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.num_devices == j.num_devices
    assert tconfig.MULTI_POD.num_devices == 512
    assert tconfig.list_archs() == jconfig.list_archs()
    assert len(tconfig.list_archs()) == 11


@pytest.mark.parametrize("reduced", [False, True])
def test_config_methods_match_jax(reduced):
    """``q_dim``, ``kv_dim``, ``attention_layer_count``,
    ``kv_bytes_per_token_per_layer``, ``kv_bytes_per_token`` and
    ``is_subquadratic`` equal ``repro.config``'s for every arch."""
    from repro_torch.config import list_archs
    for name in list_archs():
        jcfg, tcfg = jax_get_arch(name), get_arch(name)
        if reduced:
            jcfg, tcfg = jax_reduced(jcfg), reduced_config(tcfg)
        for attr in ("q_dim", "kv_dim"):
            assert getattr(tcfg, attr) == getattr(jcfg, attr), (name, attr)
        for meth in ("attention_layer_count", "is_subquadratic",
                     "kv_bytes_per_token_per_layer", "kv_bytes_per_token"):
            assert getattr(tcfg, meth)() == getattr(jcfg, meth)(), \
                (name, meth)
        for nbytes in (1, 4):
            assert tcfg.kv_bytes_per_token(nbytes) == \
                jcfg.kv_bytes_per_token(nbytes), name
            assert tcfg.kv_bytes_per_token_per_layer(nbytes) == \
                jcfg.kv_bytes_per_token_per_layer(nbytes), name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_from_jax_params_shapes_and_dtypes_for_new_configs(arch):
    """Under bf16 parameters every converted leaf has the JAX leaf's shape
    and dtype: the nested MoE dict is carried across with its float32
    router, the mLSTM gate weights and biases and the sLSTM input bias stay
    float32; ``init_params`` makes the same tree."""
    jcfg, tcfg = gemma_configs(arch)
    jrt = JaxRuntime(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    trt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), jrt)
    converted = from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg, trt,
        device="cpu")
    made = tmodel.init_params(tcfg, 0, trt, device="cpu")
    period = len(jcfg.block_pattern)
    n_periods = jcfg.num_layers // period
    jlayers = [jax.tree.map(lambda a, p=p: a[p], jparams["scan"][i])
               for p in range(n_periods) for i in range(period)]
    jlayers += list(jparams["tail"])
    n_f32 = 0
    for kind, jw, cw, mw in zip(tcfg.layer_kinds(), jlayers,
                                converted["layers"], made["layers"]):
        jflat = dict(jax.tree_util.tree_leaves_with_path(jw))
        cflat = dict(jax.tree_util.tree_leaves_with_path(cw))
        mflat = dict(jax.tree_util.tree_leaves_with_path(mw))
        assert sorted(map(str, cflat)) == sorted(map(str, mflat)) == \
            sorted(map(str, jflat)), kind
        for path, t in cflat.items():
            want = torch.float32 if jflat[path].dtype == jnp.float32 else \
                torch.bfloat16
            assert t.dtype == mflat[path].dtype == want, (kind, path)
            assert tuple(t.shape) == tuple(mflat[path].shape) == \
                jflat[path].shape, (kind, path)
            n_f32 += want == torch.float32
    assert n_f32 == sum(
        len(tmodel.FLOAT32_LEAVES[k]) if tcfg.moe is not None or
        k not in ("attn", "local", "global") else 0
        for k in tcfg.layer_kinds())
    if arch == "xlstm-1.3b":
        mlstm = made["layers"][0]
        np.testing.assert_allclose(mlstm["b_f"].numpy(),
                                   np.linspace(3, 6, tcfg.num_heads))
        assert made["layers"][7]["b_in"][1].eq(3).all()


def test_engine_caches_hold_xlstm_states_and_reset_them():
    """``build_paged_caches`` for xlstm: per-row mLSTM (c, n, m) and sLSTM
    (c, n, h, m) states of the JAX shapes and no pool; ``reset_slot``
    returns one row of every leaf to its zero state (sLSTM's ``n`` to
    1e-6), through which the next prefill starts as a fresh one, and leaves
    the other rows alone."""
    jcfg, tcfg = gemma_configs("xlstm-1.3b")
    table = np.zeros((3, 4), np.int32)
    jc = jax_layer_caches(jax_pools(jcfg, table), jcfg)
    tc = torch_pools(tcfg, table)
    zero = tmodel.init_caches(tcfg, 3, 8, TRT, device="cpu")
    for kind, want, got in zip(tcfg.layer_kinds(), jc, tc["layers"]):
        assert sorted(got) == sorted(k for k in want if k != "page_table")
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, (kind, name)
            np.testing.assert_array_equal(t.numpy(), want[name])
            t.fill_(7.0)
    tkv.reset_slot(tc, 1)
    for kind, got, z in zip(tcfg.layer_kinds(), tc["layers"],
                            zero["layers"]):
        for name, t in got.items():
            torch.testing.assert_close(t[1], z[name][1], rtol=0, atol=0)
            assert (t[0] == 7).all() and (t[2] == 7).all(), (kind, name)
        if kind == "slstm":
            assert (got["n"][1] == np.float32(1e-6)).all()
            assert (got["c"][1] == 0).all()
