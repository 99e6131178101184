"""The training loop's captured step (``repro_torch.training.train_loop.
train``: a static-buffer step, the weights, moments, step and compressor
residual updated in place, ``optimizer.apply_``), float32 on the CPU.

On the CPU the step runs eagerly through the same static tensors that its
captured graph reads and writes on the card (the routing rule).
``CPUGraphs`` (``tests/test_torch_step_graph.py``) stands in for the
card's graphs: the first step runs eagerly, the second is "captured" (the
stand-in runs the step while it records, and the state it stepped is put
back) and replayed, every later one replays, so the deferred capture, the
state restore and the launch books are exercised here.  The graphed loop
is held bit for bit to the functional step (``make_train_step``, the
eager form) applied step after step, and its first two steps to the JAX
package's jitted step at ``tests/test_torch_training.py``'s tolerances.
On the card ``chip_smoke.py`` holds a replayed run against an eager one
(``[train-gemma3-1b]``, ``[train-rgemma]``).
"""

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
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batches  # noqa: E402
from repro_torch.distributed.compression import Compressor  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import Runtime, make_layer_plan  # noqa: E402,E501
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import step_graph  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_step_graph import CPUGraphs  # noqa: E402

RT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
STEPS = 4
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=40)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(TL, "StepGraphs", CPUGraphs)


def _setup(arch="gemma3-1b", accum=1):
    cfg = reduced_config(get_arch(arch))
    params = M.init_params(cfg, 0, RT, device="cpu")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=12, batch_size=2,
                      accum_steps=accum, seed=3)
    return cfg, params, O.AdamWConfig(**OCFG), dcfg


def _copy(params, ocfg):
    p = tree_map(torch.clone, params)
    return p, O.init(ocfg, p)


def _functional(cfg, ocfg, params, dcfg, steps, accum=1, compressor=None):
    """``make_train_step`` applied ``steps`` times from a copy of
    ``params``: (params, opt_state, losses)."""
    p, o = _copy(params, ocfg)
    step = TL.make_train_step(cfg, RT, ocfg, accum_steps=accum,
                              compressor=compressor)
    data, losses = batches(dcfg), []
    for _ in range(steps):
        p, o, met = step(p, o, next(data))
        losses.append(float(met["loss"]))
    return p, o, losses


def _assert_same_state(p, o, want_p, want_o):
    assert int(o.step) == int(want_o.step)
    for tree, want in ((p, want_p), (o.m, want_o.m), (o.v, want_o.v)):
        for a, b in zip(leaves(tree), leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["accum1", "accum2", "int8"])
def test_graphed_train_equals_the_functional_step(case, stand_in):
    """Four steps through the stand-in's graphs: the losses, weights,
    moments and step equal ``make_train_step`` applied four times, bit for
    bit (with accumulation over two halves; with the int8 compressor, its
    error feedback carried across the replays)."""
    accum = 2 if case == "accum2" else 1
    cfg, params, ocfg, dcfg = _setup(accum=accum)
    comp = (lambda: Compressor("int8")) if case == "int8" else (lambda: None)
    want_p, want_o, want_losses = _functional(cfg, ocfg, params, dcfg, STEPS,
                                              accum, comp())
    p, o = _copy(params, ocfg)
    p, o, res = TL.train(cfg, RT, ocfg, batches(dcfg), steps=STEPS, params=p,
                         opt_state=o, accum_steps=accum, compressor=comp())
    assert res.losses == want_losses
    _assert_same_state(p, o, want_p, want_o)
    st = res.graphs
    assert st["eager_by_kind"] == {"train": 1}
    assert st["captures"] == 1 and st["replays"] == STEPS - 1


def test_step_one_runs_eagerly_and_step_two_captures(stand_in):
    """The key ``("train", shapes, accum_steps)``: step 1 is the eager
    run, step 2 the capture and its replay, steps 3-4 replays; nothing is
    warmed up."""
    cfg, params, ocfg, dcfg = _setup()
    _, _, res = TL.train(cfg, RT, ocfg, batches(dcfg), steps=STEPS,
                         params=params)
    st = res.graphs
    assert st["eager_by_kind"] == {"train": 1}
    assert st["captures_by_kind"] == {"train": 1}
    assert st["replays_by_kind"] == {"train": STEPS - 1}
    assert not st["warmup_launches"]
    assert st["decode_captures"] == st["prefill_captures"] == 0


def test_the_cpu_runs_every_step_eagerly():
    """Off the card (no stand-in) the same static step is called as it is:
    no capture, and the functional step's results."""
    cfg, params, ocfg, dcfg = _setup()
    want_p, want_o, want_losses = _functional(cfg, ocfg, params, dcfg, 3)
    p, o = _copy(params, ocfg)
    p, o, res = TL.train(cfg, RT, ocfg, batches(dcfg), steps=3, params=p,
                         opt_state=o)
    assert res.losses == want_losses
    _assert_same_state(p, o, want_p, want_o)
    assert res.graphs["captures"] == 0 and res.graphs["replays"] == 0


@pytest.mark.parametrize("donate", [True, False])
def test_donation_updates_the_callers_tensors_in_place(donate, stand_in):
    """``donate=True`` writes the new weights and moments into the
    caller's tensors (the returned trees are the caller's); with
    ``donate=False`` the caller's tensors keep their values."""
    cfg, params, ocfg, dcfg = _setup()
    p, o = _copy(params, ocfg)
    ptrs = [t.data_ptr() for t in leaves(p) + leaves(o.m)]
    before = [t.clone() for t in leaves(p) + leaves(o.m) + [o.step]]
    p2, o2, _ = TL.train(cfg, RT, ocfg, batches(dcfg), steps=2, params=p,
                         opt_state=o, donate=donate)
    now = leaves(p) + leaves(o.m) + [o.step]
    if donate:
        assert [t.data_ptr() for t in leaves(p2) + leaves(o2.m)] == ptrs
        assert int(o.step) == 2
        assert not all(torch.equal(a, b) for a, b in zip(now, before))
    else:
        assert all(torch.equal(a, b) for a, b in zip(now, before))
        assert int(o2.step) == 2
        assert not any(a.data_ptr() == b.data_ptr()
                       for a, b in zip(leaves(p2), leaves(p)))


def test_the_compressor_residual_is_updated_in_place(stand_in):
    """``train`` primes the residual before the first step; the steps
    write into those tensors (the captured step's fixed addresses), and the
    residual equals the eager loop's after the same steps."""
    cfg, params, ocfg, dcfg = _setup()
    comp, want = Compressor("int8"), Compressor("int8")
    _functional(cfg, ocfg, params, dcfg, 3, compressor=want)
    p, o = _copy(params, ocfg)
    comp.prime(p)
    ptrs = [t.data_ptr() for t in leaves(comp._residual)]
    TL.train(cfg, RT, ocfg, batches(dcfg), steps=3, params=p, opt_state=o,
             compressor=comp)
    assert [t.data_ptr() for t in leaves(comp._residual)] == ptrs
    for a, b in zip(leaves(comp._residual), leaves(want._residual)):
        assert torch.equal(a, b)
    assert any(bool(t.abs().sum() > 0) for t in leaves(comp._residual))


def test_a_deferred_capture_copies_no_state():
    """On the card (a capture that runs nothing), a deferred key's capture
    neither copies the rows its step updates nor puts them back; a
    stand-in whose capture runs the step does both."""
    class _Graph:
        def replay(self):
            pass

    class CardLike(step_graph.StepGraphs):
        def graphed(self, device):
            return True

        def _new_graph(self, device, step):
            return _Graph()

    class Uncopyable:
        def clone(self):
            raise AssertionError("a row was copied")

    graphs = CardLike()
    rows = [Uncopyable()]
    for _ in range(3):
        graphs.run("k", torch.device("cpu"), lambda: None,
                   state=lambda: rows, defer=True)
    assert graphs.eager_runs["k"] == 1 and graphs.captures["k"] == 1
    assert graphs.replays["k"] == 2


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_adamw_equals_apply(clip, dtype):
    """``apply_`` writes what ``apply`` returns, bit for bit, into the
    tensors it was given (every leaf, the step, the metrics), over three
    updates, with and without the clip, float32 and bf16 weights."""
    ocfg = O.AdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=2,
                         total_steps=10)
    rng = np.random.RandomState(0)
    p = {"a": torch.from_numpy(rng.randn(5, 3).astype(np.float32)).to(dtype),
         "b": [torch.from_numpy(rng.randn(7).astype(np.float32)).to(dtype)]}
    q = tree_map(torch.clone, p)
    s, s_ = O.init(ocfg, p), O.init(ocfg, q)
    ptrs = [t.data_ptr() for t in leaves(q) + leaves(s_.m) + leaves(s_.v)]
    for _ in range(3):
        g = tree_map(lambda t: torch.from_numpy(
            rng.randn(*t.shape).astype(np.float32) * 3).to(t.dtype), p)
        p, s, met = O.apply(ocfg, p, g, s)
        lr, gnorm = O.apply_(ocfg, q, g, s_)
        assert torch.equal(lr, met["lr"]) and torch.equal(gnorm,
                                                         met["grad_norm"])
        _assert_same_state(q, s_, p, s)
    assert [t.data_ptr() for t in leaves(q) + leaves(s_.m) +
            leaves(s_.v)] == ptrs


def test_replays_add_the_captured_flash_and_scan_launches(monkeypatch,
                                                          stand_in):
    """With the plain kernels standing in for counted launches, a graphed
    run of three steps counts three eager steps' flash and scan launches
    (the forward's and the scan's reversed launch in the backward): the
    eager first step as it runs, the capture put back, each replay adding
    what the capture launched."""
    for fn_name, wrapper in (("flash_attention_ref", FA.flash_attention),
                             ("rglru_scan_ref", RS.rglru_scan)):
        orig = getattr(kops.ref, fn_name)

        def counted(*a, _orig=orig, _w=wrapper, **k):
            _w.launches += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kops.ref, fn_name, counted)
    cfg, params, ocfg, dcfg = _setup("recurrentgemma-9b")
    kinds = cfg.layer_kinds()
    f0, s0 = FA.flash_attention.launches, RS.rglru_scan.launches
    TL.train(cfg, RT, ocfg, batches(dcfg), steps=3, params=params)
    assert FA.flash_attention.launches - f0 == 3 * kinds.count("local")
    assert RS.rglru_scan.launches - s0 == 3 * 2 * kinds.count("rglru")


def _to_jax(tree: dict, like, cfg):
    """The port's parameter tree (or a moment tree like it) in the JAX
    package's layout: ``models.convert.from_jax_params`` backwards (the
    periods' layers stacked under ``"scan"``, the rest under ``"tail"``),
    each leaf in ``like``'s dtype."""
    plan = make_layer_plan(cfg.num_layers, cfg.block_pattern)
    per, layers = len(plan.period_kinds), tree["layers"]

    def arr(t, ref):
        return jnp.asarray(t.detach().numpy(), ref.dtype)

    def stack(pos, ref, path=()):
        out = {}
        for k, r in ref.items():
            if isinstance(r, dict):
                out[k] = stack(pos, r, path + (k,))
                continue
            rows = []
            for p in range(plan.n_periods):
                t = layers[p * per + pos]
                for name in path + (k,):
                    t = t[name]
                rows.append(t.detach().numpy())
            out[k] = jnp.asarray(np.stack(rows), r.dtype)
        return out

    def tail(t, ref):
        return {k: tail(t[k], r) if isinstance(r, dict) else arr(t[k], r)
                for k, r in ref.items()}

    n = plan.n_periods * per
    return {"embed": {k: arr(tree["embed"][k], r)
                      for k, r in like["embed"].items()},
            "final_norm": arr(tree["final_norm"], like["final_norm"]),
            "scan": [stack(pos, r) for pos, r in enumerate(like["scan"])],
            "tail": [tail(layers[n + i], r)
                     for i, r in enumerate(like["tail"])]}


def _assert_like_jax(got, jwant, cfg, lr):
    """``test_train_step_matches_jax``'s tolerances: every parameter
    within the step's ``lr``, all but 1e-3 of each leaf within 1e-4
    relative (+ 1e-6)."""
    want = from_jax_params(jax.tree.map(np.asarray, jwant), cfg, RT,
                           device="cpu")
    for i, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        diff = (a - b).abs()
        assert float(diff.max()) <= lr, i
        n_off = int((diff > 1e-4 * b.abs() + 1e-6).sum())
        assert n_off <= 1e-3 * diff.numel(), (i, tuple(a.shape), n_off)


@pytest.mark.parametrize("accum", [1, 2])
def test_graphed_steps_match_jax(accum, stand_in):
    """Each of the graphed loop's first two steps (the eager one, then the
    capture's replay) against ``jax.jit(JTL.make_train_step(...))`` from
    the same state and batch, at ``test_train_step_matches_jax``'s
    tolerances: the loss within 1e-5 and the parameters
    (``_assert_like_jax``).  Step 2's JAX side starts from
    the port's state after step 1, carried into the JAX layout."""
    jcfg = jax_reduced(jax_get_arch("gemma3-1b"))
    cfg = reduced_config(get_arch("gemma3-1b"))
    ocfg, jocfg = O.AdamWConfig(**OCFG), JO.AdamWConfig(**OCFG)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, RT,
                             device="cpu")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=12, batch_size=4,
                      accum_steps=accum, seed=3)
    p1, o1, _ = TL.train(cfg, RT, ocfg, batches(dcfg), steps=1,
                         params=params, accum_steps=accum, donate=False)
    p2, _, res = TL.train(cfg, RT, ocfg, batches(dcfg), steps=2,
                          params=params, accum_steps=accum, donate=False)
    assert res.graphs["replays"] == 1
    jstep = jax.jit(JTL.make_train_step(jcfg, JRT, jocfg,
                                        accum_steps=accum))
    data = batches(dcfg)
    starts = [(jparams, JO.init(jocfg, jparams)),
              (_to_jax(p1, jparams, cfg), JO.AdamWState(
                  jnp.asarray(1, jnp.int32), _to_jax(o1.m, jparams, cfg),
                  _to_jax(o1.v, jparams, cfg)))]
    for k, ((jp, jo), got) in enumerate(zip(starts, (p1, p2))):
        jp, _, jmet = jstep(jp, jo, {n: jnp.asarray(v)
                                     for n, v in next(data).items()})
        np.testing.assert_allclose(res.losses[k], float(jmet["loss"]),
                                   rtol=1e-5)
        _assert_like_jax(got, jp, cfg, float(jmet["lr"]))
