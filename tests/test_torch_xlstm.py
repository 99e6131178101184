"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``) on the same numpy inputs, float32 on
the CPU.

The mLSTM step and the sequential recurrence agree within 1e-5 (relative
and absolute); the chunkwise form within 1e-4, because its intra-chunk
sums run in another order and ``h = num / den`` magnifies a rounding
difference where ``den`` is small.  The blocks run a right-padded prefill
(``valid`` masks) and then decode steps from the carried state.
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
from repro.models import xlstm as jx  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

STEP_TOL = 1e-5
CHUNK_TOL = 1e-4
JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
B, H, DH = 2, 2, 16


def inputs(seed, s):
    rng = np.random.RandomState(seed)
    q, k, v = [rng.randn(B, s, H, DH).astype(np.float32) for _ in range(3)]
    i_raw = rng.randn(B, s, H).astype(np.float32)
    f_raw = (rng.randn(B, s, H) + 3.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


def state(seed):
    rng = np.random.RandomState(seed)
    return {"c": (0.1 * rng.randn(B, H, DH, DH)).astype(np.float32),
            "n": (0.1 * rng.randn(B, H, DH)).astype(np.float32),
            "m": rng.randn(B, H).astype(np.float32)}


def J(tree):
    return jax.tree.map(jnp.asarray, tree)


def T(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def close(got, want, tol):
    """A port tensor (or dict of them) against the JAX array(s)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for name in got:
            close(got[name], want[name], tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_mlstm_step_matches_jax():
    q, k, v, i_raw, f_raw = inputs(0, 1)
    st = state(1)
    jh, js = jx.mlstm_step(*J((q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                               f_raw[:, 0])), J(st))
    th, ts = tx.mlstm_step(*T((q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                               f_raw[:, 0])), T(st))
    close(th, jh, STEP_TOL)
    close(ts, js, STEP_TOL)


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_sequential_matches_jax(carried):
    x = inputs(2, 20)
    st = state(3) if carried else None
    jh, js = jx.mlstm_sequential(*J(x), None if st is None else J(st))
    th, ts = tx.mlstm_sequential(*T(x), None if st is None else T(st))
    close(th, jh, STEP_TOL)
    close(ts, js, STEP_TOL)


@pytest.mark.parametrize("s,chunk", [(24, 64), (24, 8), (24, 5), (37, 16),
                                     (64, 64), (65, 64)])
def test_mlstm_chunkwise_matches_jax_and_sequential(s, chunk):
    """Chunk lengths that divide S, that do not (a ragged tail padded with
    identity steps) and that exceed it; from a carried state."""
    x = inputs(4 + s, s)
    st = state(5)
    jh, js = jx.mlstm_chunkwise(*J(x), J(st), chunk=chunk)
    th, ts = tx.mlstm_chunkwise(*T(x), T(st), chunk=chunk)
    close(th, jh, CHUNK_TOL)
    close(ts, js, CHUNK_TOL)
    sh, ss = tx.mlstm_sequential(*T(x), T(st))
    torch.testing.assert_close(th, sh, rtol=CHUNK_TOL, atol=CHUNK_TOL)
    for name in ss:
        torch.testing.assert_close(ts[name], ss[name], rtol=CHUNK_TOL,
                                   atol=CHUNK_TOL)
    assert torch.isfinite(th).all()


def xlstm_weights():
    """One mLSTM and one sLSTM layer of reduced xlstm-1.3b (d_model 64,
    4 heads of 16), from the JAX package's ``init_params``."""
    cfg = jax_reduced(jax_get_arch("xlstm-1.3b"))
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0), JRT)
    kinds = cfg.block_pattern
    take = {kind: {k: np.asarray(a[0]) for k, a in
                   params["scan"][kinds.index(kind)].items()}
            for kind in ("mlstm", "slstm")}
    return cfg, take


@pytest.mark.parametrize("kind,sequential", [("mlstm", False),
                                             ("mlstm", True),
                                             ("slstm", False)])
def test_blocks_prefill_then_decode_match_jax(kind, sequential):
    """A right-padded prefill (row 1 has 13 real tokens of 24; its pad
    steps leave the state as it was) from the zero state, then four
    decode steps from the carried state: outputs and states against the
    JAX blocks at every step."""
    cfg, ws = xlstm_weights()
    w = ws[kind]
    heads, dr = cfg.num_heads, cfg.d_rnn
    rng = np.random.RandomState(6)
    x = rng.randn(B, 24, cfg.d_model).astype(np.float32)
    valid = np.ones((B, 24), bool)
    valid[1, 13:] = False
    if kind == "mlstm":
        st = {k: np.asarray(a) for k, a in
              jx.mlstm_zero_state(B, heads, dr // heads).items()}
        jf, tf = jx.mlstm_block, tx.mlstm_block
        kw = dict(use_sequential=sequential, chunk=8)
    else:
        st = {k: np.asarray(a) for k, a in jx.slstm_zero_state(B, dr).items()}
        jf, tf = jx.slstm_block, tx.slstm_block
        kw = {}
    tol = STEP_TOL if kind == "slstm" or sequential else CHUNK_TOL
    jy, js = jf(jnp.asarray(x), J(w), heads, mode="prefill", state=J(st),
                valid=jnp.asarray(valid), **kw)
    ty, ts = tf(torch.from_numpy(x), T(w), heads, mode="prefill",
                state=T(st), valid=torch.from_numpy(valid), **kw)
    close(ty, jy, tol)
    close(ts, js, tol)
    # row 1's state equals that of its 13 real tokens alone
    _, short = tf(torch.from_numpy(x[1:, :13]), T(w), heads, mode="prefill",
                  state={k: t[1:] for k, t in T(st).items()}, **kw)
    for name in short:
        torch.testing.assert_close(ts[name][1:], short[name], rtol=tol,
                                   atol=tol)
    for step in range(4):
        xt = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        jy, js = jf(jnp.asarray(xt), J(w), heads, mode="decode", state=js)
        ty, ts = tf(torch.from_numpy(xt), T(w), heads, mode="decode",
                    state=ts)
        close(ty, jy, tol)
        close(ts, js, tol)


def test_zero_states_match_jax():
    for got, want in ((tx.mlstm_zero_state(3, 4, 8), jx.mlstm_zero_state(
            3, 4, 8)), (tx.slstm_zero_state(3, 16), jx.slstm_zero_state(3,
                                                                        16))):
        for name in want:
            assert got[name].dtype == torch.float32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    assert float(tx.slstm_zero_state(1, 4)["n"][0, 0]) == \
        np.float32(1e-6)
