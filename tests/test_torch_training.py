"""The port's training stack against the JAX package's: the 16 tests of
``tests/test_training.py`` run on ``repro_torch`` (AdamW, schedules,
clipping, the train loop and gradient accumulation, the gradient
compressors, checkpoints, the data pipeline), with AdamW, the schedules,
the clip and the compressors held to ``repro`` on the same arrays and the
data batches equal bit for bit; one train step of both packages on the
same weights; ``tests/test_system.py::test_train_crash_restart_workflow``
on the port; and the port's training CLI.  Float32 on the CPU.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402,E501
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.distributed import compression as jax_comp  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,  # noqa: E402
                                       batches)
from repro_torch.distributed.compression import (  # noqa: E402
    Compressor, int8_compress, int8_decompress, topk_compress,
    topk_decompress)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

RT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)


def tiny(name):
    return reduced_config(get_arch(name))


def init(cfg, seed=0):
    return M.init_params(cfg, seed, RT, device="cpu")


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------- adamw ---

def test_adamw_single_step_matches_numpy():
    cfg = O.AdamWConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8,
                        weight_decay=0.0, grad_clip=0.0,
                        schedule="constant", warmup_steps=0)
    p = {"w": t([1.0, -2.0])}
    g = {"w": t([0.5, 0.5])}
    st_ = O.init(cfg, p)
    newp, st2, _ = O.apply(cfg, p, g, st_)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.99)
    want = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(float(newp["w"][0]), want, rtol=1e-6)
    assert int(st2.step) == 1


def test_weight_decay_pulls_to_zero():
    cfg = O.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0,
                        schedule="constant", warmup_steps=0)
    p = {"w": t([4.0])}
    g = {"w": t([0.0])}
    newp, _, _ = O.apply(cfg, p, g, O.init(cfg, p))
    assert float(newp["w"][0]) < 4.0


def test_schedule_shapes():
    cfg = O.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_ratio=0.1, schedule="cosine")
    assert float(O.schedule_lr(cfg, 0)) == pytest.approx(0.0)
    assert float(O.schedule_lr(cfg, 10)) == pytest.approx(1.0)
    assert float(O.schedule_lr(cfg, 110)) == pytest.approx(0.1, rel=1e-3)


def test_grad_clip():
    g = {"a": t([3.0, 4.0])}          # norm 5
    clipped, norm = O.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=60, min_lr_ratio=0.2,
              schedule=schedule)
    cfg, jcfg = O.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    for step in (0, 1, 6, 7, 8, 30, 59, 60, 90):
        np.testing.assert_allclose(
            float(O.schedule_lr(cfg, torch.tensor(step, dtype=torch.int32))),
            float(JO.schedule_lr(jcfg, jnp.asarray(step, jnp.int32))),
            rtol=1e-6)


def test_adamw_and_clip_match_jax_over_steps():
    """Five AdamW steps with clipping and weight decay on the same random
    tree and gradients: parameters, moments and metrics as the JAX
    optimizer's."""
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 3), "b": {"c": (5,), "d": (2, 2, 2)}}

    def rand(s):
        if isinstance(s, dict):
            return {k: rand(v) for k, v in s.items()}
        return rng.randn(*s).astype(np.float32)

    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5,
              weight_decay=0.1)
    cfg, jcfg = O.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    p_np = rand(shapes)
    p = jax.tree.map(t, p_np)
    jp = jax.tree.map(jnp.asarray, p_np)
    st_, jst = O.init(cfg, p), JO.init(jcfg, jp)
    for _ in range(5):
        g_np = jax.tree.map(lambda a: 3.0 * a, rand(shapes))
        p, st_, met = O.apply(cfg, p, jax.tree.map(t, g_np), st_)
        jp, jst, jmet = JO.apply(jcfg, jp, jax.tree.map(jnp.asarray, g_np),
                                 jst)
        for a, b in zip(jax.tree.leaves((p, st_.m, st_.v)),
                        jax.tree.leaves((jp, jst.m, jst.v))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    assert int(st_.step) == int(jst.step) == 5
    clipped, norm = O.clip_by_global_norm(jax.tree.map(t, p_np), 0.5)
    jclipped, jnorm = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, p_np),
                                             0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(clipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------- train loop ---

def test_loss_descends_and_accum_equivalence():
    cfg = tiny("minitron-4b")
    ocfg = O.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40,
                         grad_clip=1.0)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, batch_size=4)
    params, opt_state, res = TL.train(cfg, RT, ocfg, batches(dcfg), steps=20,
                                      device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.3

    # accumulation: accum=2 over half batches == one full batch
    params = init(cfg)
    batch = next(batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    batch_size=4, seed=7)))
    batch["loss_mask"] = np.ones_like(batch["loss_mask"])
    split = {k: np.stack([v[:2], v[2:]]) for k, v in batch.items()}
    step1 = TL.make_train_step(cfg, RT, ocfg, accum_steps=1)
    step2 = TL.make_train_step(cfg, RT, ocfg, accum_steps=2)
    p1, _, m1 = step1(params, O.init(ocfg, params), batch)
    p2, _, m2 = step2(params, O.init(ocfg, params), split)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """One train step of both packages on the same weights and batch
    (clip, warmup, weight decay; with accumulation over two halves): the
    loss, the metrics and every updated parameter."""
    jcfg = jax_reduced(jax_get_arch("gemma3-1b"))
    cfg = tiny("gemma3-1b")
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=40)
    ocfg, jocfg = O.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, RT,
                             device="cpu")
    batch = next(batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                                    batch_size=4, seed=3)))
    if accum > 1:
        batch = {k: np.stack([v[:2], v[2:]]) for k, v in batch.items()}
    p, _, met = TL.make_train_step(cfg, RT, ocfg, accum_steps=accum)(
        params, O.init(ocfg, params), batch)
    jp, _, jmet = jax.jit(JTL.make_train_step(jcfg, JRT, jocfg,
                                              accum_steps=accum))(
        jparams, JO.init(jocfg, jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    for name in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=1e-5, err_msg=name)
    # AdamW's first step moves each parameter by about lr * g / |g|, so a
    # gradient within float32 rounding of eps (1e-8) may move its
    # parameter by anything up to lr in one package and not the other:
    # every parameter within the step's lr, and all but 1e-3 of each leaf
    # within 1e-4 relative (a share a leaf, so no whole leaf, a norm scale
    # say, can be off by about lr and hide in a larger leaf's share)
    want = from_jax_params(jax.tree.map(np.asarray, jp), cfg, RT,
                           device="cpu")
    lr = float(met["lr"])
    for i, (a, b) in enumerate(zip(leaves(p), leaves(want))):
        diff = (a - b).abs()
        assert float(diff.max()) <= lr, i
        n_off = int((diff > 1e-4 * b.abs() + 1e-6).sum())
        assert n_off <= 1e-3 * diff.numel(), (i, tuple(a.shape), n_off)


# ---------------------------------------------------------- compression ---

def test_int8_roundtrip_error_bound():
    x = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    q, s = int8_compress(x)
    y = int8_decompress(q, s)
    assert float((x - y).abs().max()) <= float(s) * 0.5 + 1e-7
    jq, js = jax_comp.int8_compress(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_topk_keeps_largest():
    x = t([0.1, -5.0, 0.2, 3.0, -0.05])
    vals, idx, shape = topk_compress(x, 0.4)
    y = topk_decompress(vals, idx, shape)
    np.testing.assert_allclose(y.numpy(), [0.0, -5.0, 0.0, 3.0, 0.0],
                               atol=1e-6)
    jv, ji, _ = jax_comp.topk_compress(jnp.asarray(x.numpy()), 0.4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_topk_ties_keep_the_lower_index_as_jax_does():
    x = t([1.0, -2.0, 2.0, 0.5, -2.0, 1.0])
    for frac in (0.2, 0.4, 0.6):
        _, idx, _ = topk_compress(x, frac)
        _, jidx, _ = jax_comp.topk_compress(jnp.asarray(x.numpy()), frac)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_error_feedback_accumulates():
    """With EF, the *sum* of compressor outputs over steps converges to the
    sum of inputs; every output equals the JAX compressor's."""
    comp = Compressor(method="topk", topk_frac=0.25)
    jcomp = jax_comp.Compressor(method="topk", topk_frac=0.25)
    w = [1.0, 0.1, 0.01, 0.001]
    g, jg = {"w": t(w)}, {"w": jnp.asarray(w, jnp.float32)}
    total = np.zeros(4)
    for _ in range(50):
        out = comp.roundtrip(g)["w"].numpy()
        np.testing.assert_array_equal(out, np.asarray(jcomp.roundtrip(jg)["w"]))
        total += out
    np.testing.assert_allclose(total / 50, w, rtol=0.15, atol=0.02)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressor_roundtrip_matches_jax(method):
    """Ten rounds over a two-leaf gradient tree with error feedback: each
    round's outputs as the JAX compressor's, bit for bit."""
    rng = np.random.RandomState(5)
    comp = Compressor(method=method, topk_frac=0.1)
    jcomp = jax_comp.Compressor(method=method, topk_frac=0.1)
    for _ in range(10):
        g = {"a": rng.randn(40).astype(np.float32),
             "b": rng.randn(3, 7).astype(np.float32)}
        got = comp.roundtrip(jax.tree.map(t, g))
        want = jcomp.roundtrip(jax.tree.map(jnp.asarray, g))
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert comp.wire_bytes(got) == jcomp.wire_bytes(want)


def test_compression_ratio():
    comp = Compressor(method="int8")
    g = {"w": torch.zeros(1024)}
    assert comp.compression_ratio(g) > 3.5
    comp2 = Compressor(method="topk", topk_frac=0.01)
    assert comp2.compression_ratio(g) > 40
    jg = {"w": jnp.zeros((1024,), jnp.float32)}
    assert comp.compression_ratio(g) == \
        jax_comp.Compressor(method="int8").compression_ratio(jg)
    assert comp2.compression_ratio(g) == jax_comp.Compressor(
        method="topk", topk_frac=0.01).compression_ratio(jg)


def test_training_converges_with_compression():
    cfg = tiny("minitron-4b")
    ocfg = O.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, batch_size=4)
    comp = Compressor(method="int8")
    _, _, res = TL.train(cfg, RT, ocfg, batches(dcfg), steps=15,
                         compressor=comp, device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.2


def _off_share(got, want) -> float:
    """The share of parameter elements more than 1e-4 relative (+ 1e-6)
    from ``want``'s."""
    off = total = 0
    for a, b in zip(leaves(got), leaves(want)):
        off += int(((a - b).abs() > 1e-4 * b.abs() + 1e-6).sum())
        total += a.numel()
    return off / total


def test_reference_train_freezes_error_feedback(monkeypatch):
    """Reference defect that the port does not reproduce (ROADMAP Queue 3):
    ``repro``'s ``train`` jits a step whose ``Compressor.roundtrip`` keeps
    its residual on ``self``, so the trace freezes a zero residual into
    the compiled step and leaves ``_residual`` holding the trace's
    tracers: a jitted roundtrip returns the same output at every call,
    where the eager one carries the residual.  The port's graphed
    ``train`` writes its residual in place, so its step 2 equals its eager
    loop's bit for bit and JAX's eager (unjitted) loop's at
    ``test_train_step_matches_jax``'s tolerance, and lies far from JAX's
    ``train``."""
    from test_torch_step_graph import CPUGraphs
    monkeypatch.setattr(TL, "StepGraphs", CPUGraphs)
    jcfg = jax_reduced(jax_get_arch("gemma3-1b"))
    cfg = tiny("gemma3-1b")
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=40)
    ocfg, jocfg = O.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, RT,
                             device="cpu")
    dk = dict(vocab_size=cfg.vocab_size, seq_len=12, batch_size=4, seed=3)
    jcomp = jax_comp.Compressor("int8")
    JTL.train(jcfg, JRT, jocfg, jax_data.batches(
        jax_data.DataConfig(**dk)), steps=3, params=jparams,
        compressor=jcomp, donate=False)
    assert all(isinstance(r, jax.core.Tracer)
               for r in jax.tree.leaves(jcomp._residual))
    g = {"w": jnp.asarray(np.random.RandomState(0).randn(50).astype(
        np.float32))}
    jitted = jax.jit(jax_comp.Compressor("int8").roundtrip)
    outs = [np.asarray(jitted(g)["w"]) for _ in range(3)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    eager = jax_comp.Compressor("int8")
    outs = [np.asarray(eager.roundtrip(g)["w"]) for _ in range(3)]
    assert not any(np.array_equal(outs[0], o) for o in outs[1:])

    # two steps on each side: the port's graphed loop (step 2 a replay),
    # its functional loop, JAX's eager loop and JAX's train
    p, _, res = TL.train(cfg, RT, ocfg, batches(DataConfig(**dk)), steps=2,
                         params=params, compressor=Compressor("int8"),
                         donate=False)
    assert res.graphs["replays"] == 1
    step = TL.make_train_step(cfg, RT, ocfg, compressor=Compressor("int8"))
    ep, eo, data = params, O.init(ocfg, params), batches(DataConfig(**dk))
    jstep = JTL.make_train_step(jcfg, JRT, jocfg,
                                compressor=jax_comp.Compressor("int8"))
    jep, jeo = jparams, JO.init(jocfg, jparams)
    jdata = jax_data.batches(jax_data.DataConfig(**dk))
    for _ in range(2):
        ep, eo, _ = step(ep, eo, next(data))
        jep, jeo, _ = jstep(jep, jeo, {k: jnp.asarray(v)
                                       for k, v in next(jdata).items()})
    for a, b in zip(leaves(p), leaves(ep)):
        assert torch.equal(a, b)
    jp2, _, _ = JTL.train(jcfg, JRT, jocfg, jax_data.batches(
        jax_data.DataConfig(**dk)), steps=2, params=jparams,
        compressor=jax_comp.Compressor("int8"), donate=False)

    def port(tree):
        return from_jax_params(jax.tree.map(np.asarray, tree), cfg, RT,
                               device="cpu")
    assert _off_share(p, port(jep)) <= 1e-3
    assert _off_share(p, port(jp2)) > 0.1


# ----------------------------------------------------------- checkpoint ---

def test_checkpoint_roundtrip_and_retention():
    cfg = tiny("yi-9b")
    params = init(cfg)
    ocfg = O.AdamWConfig()
    opt = O.init(ocfg, params)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (10, 20, 30):
            mgr.save(step, {"params": params, "opt_state": opt},
                     {"step": step})
        assert mgr.steps() == [20, 30]          # retention
        restored, meta = mgr.restore({"params": params, "opt_state": opt})
        assert meta["step"] == 30
        for a, b in zip(leaves(restored["params"]), leaves(params)):
            assert torch.equal(a, b)
        assert restored["opt_state"].step.dtype == torch.int32


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"w": torch.zeros(4)})
        with pytest.raises(ValueError):
            mgr.restore({"w": torch.zeros(5)})


def test_checkpoint_no_tmp_left_behind():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(5, {"x": torch.ones(2)})
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_checkpoint_layout_is_the_jax_managers():
    """The same tree (a dict, a list, a named-tuple optimizer state) saved
    by both managers: the same step directory, leaf file names and
    manifest shapes; a bfloat16 leaf is restored exactly, on the template's
    dtype."""
    tree = {"params": {"w": np.ones((2, 3), np.float32),
                       "layers": [np.zeros(4, np.float32)]},
            "opt_state": None}
    port = {"params": jax.tree.map(t, tree["params"])}
    port["opt_state"] = O.init(O.AdamWConfig(), port["params"])
    jtree = {"params": jax.tree.map(jnp.asarray, tree["params"])}
    jtree["opt_state"] = JO.init(JO.AdamWConfig(), jtree["params"])
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(os.path.join(d, "port")).save(7, port)
        JaxManager(os.path.join(d, "jax")).save(7, jtree)
        mans = [json.load(open(os.path.join(d, who, "step_00000007",
                                            "manifest.json")))
                for who in ("port", "jax")]
        assert sorted(os.listdir(os.path.join(d, "port", "step_00000007"))) \
            == sorted(os.listdir(os.path.join(d, "jax", "step_00000007")))
        assert {k: v["shape"] for k, v in mans[0]["leaves"].items()} == \
            {k: v["shape"] for k, v in mans[1]["leaves"].items()}
        bf = {"w": torch.randn(5).to(torch.bfloat16)}
        mgr = CheckpointManager(os.path.join(d, "bf16"))
        mgr.save(1, bf)
        back, _ = mgr.restore({"w": torch.zeros(5, dtype=torch.bfloat16)})
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"], bf["w"])


def test_resume_continues_step_count():
    cfg = tiny("minitron-4b")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        p, o, _ = TL.train(cfg, RT, ocfg, batches(dcfg), steps=3,
                           checkpoint_mgr=mgr, checkpoint_every=3,
                           device="cpu")
        assert mgr.latest_step() == 3
        (restored, _) = mgr.restore({"params": p, "opt_state": o})
        p2, o2, _ = TL.train(cfg, RT, ocfg, batches(dcfg), steps=2,
                             params=restored["params"],
                             opt_state=restored["opt_state"])
        assert int(o2.step) == 5


def test_train_crash_restart_workflow():
    """``tests/test_system.py::test_train_crash_restart_workflow`` on the
    port: train, 'crash', restore from the atomic checkpoint, replay the
    data stream, continue; the final state equals an uninterrupted
    run's."""
    cfg = tiny("gemma3-1b")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)

    p_ref, o_ref, _ = TL.train(cfg, RT, ocfg, batches(dcfg), steps=6,
                               device="cpu")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        p1, o1, _ = TL.train(cfg, RT, ocfg, batches(dcfg), steps=3,
                             checkpoint_mgr=mgr, checkpoint_every=3,
                             device="cpu")
        del p1, o1                           # "crash"
        template = {"params": init(cfg), "opt_state": O.init(ocfg,
                                                             init(cfg))}
        restored, _ = mgr.restore(template)
        it2 = batches(dcfg)
        for _ in range(3):
            next(it2)
        p2, o2, _ = TL.train(cfg, RT, ocfg, it2, steps=3,
                             params=restored["params"],
                             opt_state=restored["opt_state"])
    assert int(o2.step) == int(o_ref.step) == 6
    for a, b in zip(leaves(p_ref), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-5)


def test_training_cli_trains_checkpoints_and_resumes(capsys):
    """``python -m repro_torch.launch.train --device cpu``: a run, then a
    ``--resume`` run that continues the step count from the final
    checkpoint, through the int8 compressor."""
    with tempfile.TemporaryDirectory() as d:
        base = ["--device", "cpu", "--arch", "gemma3-1b", "--batch", "2",
                "--seq", "16", "--ckpt-dir", d, "--log-every", "1"]
        train_cli.main(base + ["--steps", "3"])
        train_cli.main(base + ["--steps", "2", "--resume", "--compress",
                               "int8"])
        out = capsys.readouterr().out
        assert "resumed from step 3" in out
        assert "step 5: loss=" in out
        mgr = CheckpointManager(os.path.join(d, "gemma3-1b-smoke"))
        assert mgr.latest_step() == 5


def test_training_cli_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.setup(train_cli.parse_args(["--arch", "gemma3-1b"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.train(tiny("gemma3-1b"), RT, O.AdamWConfig(), iter([]), steps=0)


# ------------------------------------------------------------------ data ---

def test_data_deterministic_and_sharded():
    dcfg = DataConfig(vocab_size=64, seq_len=16, batch_size=4, seed=3)
    a = next(batches(dcfg))
    b = next(batches(dcfg))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 16)
    assert a["labels"].shape == (4, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    h0 = next(batches(dcfg, host_index=0, host_count=2))
    h1 = next(batches(dcfg, host_index=1, host_count=2))
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_data_has_learnable_structure():
    dcfg = DataConfig(vocab_size=128, seq_len=64, batch_size=8, seed=0)
    gen = SyntheticTokens(dcfg)
    doc = gen.document()
    assert doc.min() >= 1 and doc.max() < 128
    b = next(batches(dcfg))
    toks = b["tokens"]
    nxt = gen._next[toks[:, :-1]]
    hit = (nxt == toks[:, 1:]).mean()
    assert hit > 0.3


@pytest.mark.parametrize("kw", [dict(), dict(accum_steps=3, seed=4),
                                dict(batch_size=3, seq_len=33, seed=9)])
def test_data_batches_equal_jax_bit_for_bit(kw):
    base = dict(vocab_size=97, seq_len=20, batch_size=2)
    port = batches(DataConfig(**{**base, **kw}), host_index=1, host_count=2)
    ref = jax_data.batches(jax_data.DataConfig(**{**base, **kw}),
                           host_index=1, host_count=2)
    for _ in range(4):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert dataclasses.asdict(DataConfig(**base)) == \
        dataclasses.asdict(jax_data.DataConfig(**base))
