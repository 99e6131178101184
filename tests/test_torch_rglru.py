"""The Griffin recurrent block of the PyTorch port against the JAX package.

The port's plain scan (``repro_torch.kernels.ref.rglru_scan_ref``, a loop
over time) is held against the JAX Pallas kernel run as
``tests/test_kernels.py`` runs it (``interpret=True``) and against the JAX
oracle (``repro.kernels.ref.rglru_scan_ref``, an associative scan), at
``tests/test_kernels.py``'s shapes and its tolerance (``rtol = 1e-4, atol
= 1e-5``: a loop and a tree of products round differently).  The block's
pieces (``repro_torch.models.rglru``) are held against
``repro.models.rglru`` in float32 at ``1e-5`` (the einsums and the scan
sum in another order).  The CUDA kernel itself is compared with the plain
version by the ``cuda``-marked tests, which need the card and skip
elsewhere; JAX is imported inside the tests, so that those collect on a
machine without it (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as cuda_scan  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

TOL = 1e-5
# (B, S, Dr, s_blk, d_blk): tests/test_kernels.py's RGLRU_SWEEP
SWEEP = [(1, 32, 128, 16, 128), (2, 100, 256, 32, 128), (3, 17, 128, 8, 128),
         (1, 257, 512, 64, 256)]


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    from repro.kernels.rglru_scan import rglru_scan_pallas
    from repro.models import rglru as jax_rglru
    return jax, jnp, jax_ref, rglru_scan_pallas, jax_rglru


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def scan_inputs(b, s, dr, seed=0):
    """a in (0, 1) as the gates make it, b and h0 normal."""
    rng = np.random.RandomState(seed)
    a = (1.0 / (1.0 + np.exp(-rng.randn(b, s, dr)))).astype(np.float32)
    bb = rng.randn(b, s, dr).astype(np.float32)
    h0 = rng.randn(b, dr).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("case", SWEEP)
def test_plain_scan_matches_pallas_kernel_and_jax_oracle(case, with_h0):
    _, jnp, jax_ref, pallas_scan, _ = _jax()
    b, s, dr, sblk, dblk = case
    a, bb, h0 = scan_inputs(b, s, dr)
    if not with_h0:
        h0 = np.zeros_like(h0)
    got = ref.rglru_scan_ref(_t(a), _t(bb),
                             _t(h0) if with_h0 else None).numpy()
    kernel = np.asarray(pallas_scan(jnp.asarray(a), jnp.asarray(bb),
                                    jnp.asarray(h0), s_blk=sblk, d_blk=dblk,
                                    interpret=True))
    oracle = np.asarray(jax_ref.rglru_scan_ref(
        jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0)))
    np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-5)


def test_plain_scan_rounds_each_step_twice():
    """Step t is round(round(a_t * h) + b_t): a multiply and an add, never
    a fused multiply-add, as the CUDA kernel computes it."""
    a, bb, h0 = scan_inputs(2, 9, 24, seed=1)
    got = ref.rglru_scan_ref(_t(a), _t(bb), _t(h0)).numpy()
    h = h0.copy()
    for t in range(9):
        h = (a[:, t] * h).astype(np.float32)
        h = (h + bb[:, t]).astype(np.float32)
        np.testing.assert_array_equal(got[:, t], h)


def test_router_takes_plain_version_on_cpu():
    a, bb, h0 = scan_inputs(2, 11, 40, seed=2)
    before = cuda_scan.rglru_scan.launches
    out = ops.rglru_scan(_t(a), _t(bb), _t(h0))
    np.testing.assert_array_equal(
        out.numpy(), ref.rglru_scan_ref(_t(a), _t(bb), _t(h0)).numpy())
    assert cuda_scan.rglru_scan.launches == before


def test_kernel_refuses_dr_not_a_multiple_of_4_before_any_launch():
    """TMA needs 16-byte rows: the shape check raises on any device, so a
    CPU caller of ``check_inputs`` sees the rule, and the wrapper raises
    before it launches."""
    a, bb, _ = scan_inputs(1, 8, 6, seed=3)
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_scan.check_inputs(_t(a), _t(bb), None)
    before = cuda_scan.rglru_scan.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_scan.rglru_scan(_t(a), _t(bb))
    assert cuda_scan.rglru_scan.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    a, bb, h0 = scan_inputs(1, 8, 32, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.rglru_scan(_t(a), _t(bb), _t(h0))


# ---------------------------------------------------------------------------
# the block's pieces against repro.models.rglru (float32)
# ---------------------------------------------------------------------------

B, S, D, DR, H, CW = 2, 10, 24, 32, 4, 4


def block_weights(seed=0):
    rng = np.random.RandomState(seed)
    dh = DR // H

    def n(*shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    a = rng.uniform(0.9, 0.999, DR)
    return {"wg": n(D, DR, fan_in=D), "wx": n(D, DR, fan_in=D),
            "conv_w": n(CW, DR, fan_in=CW),
            "conv_b": (0.1 * rng.randn(DR)).astype(np.float32),
            "gate_a_w": n(H, dh, dh, fan_in=dh),
            "gate_a_b": (0.1 * rng.randn(DR)).astype(np.float32),
            "gate_x_w": n(H, dh, dh, fan_in=dh),
            "gate_x_b": (0.1 * rng.randn(DR)).astype(np.float32),
            "lam": np.log(np.expm1(-np.log(a) / 8.0)).astype(np.float32),
            "wo": n(DR, D, fan_in=DR)}


def _both(w):
    _, jnp, *_ = _jax()
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: _t(v) for k, v in w.items()})


def test_gates_match_jax():
    _, jnp, _, _, jax_rglru = _jax()
    jw, tw = _both(block_weights())
    x = np.random.RandomState(1).randn(B, S, DR).astype(np.float32)
    ja, jb = jax_rglru.rglru_gates(jnp.asarray(x), jw, H)
    ta, tb = trglru.rglru_gates(_t(x), tw, H)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL, atol=TOL)


def test_softplus_is_not_cut_off_above_twenty():
    """``jax.nn.softplus`` everywhere, where torch's returns x past 20."""
    jax, jnp, *_ = _jax()
    x = np.asarray([-30.0, -5.0, 0.0, 3.0, 19.5, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(trglru.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_state,lengths", [
    (False, None), (True, None), (True, (S, 6)), (True, (0, 3))])
def test_causal_conv1d_matches_jax(with_state, lengths):
    """With and without a carried state; right-padded rows (``valid``)
    carry the window ending at their last real input, and a row with no
    real input keeps its state."""
    _, jnp, *_, jax_rglru = _jax()
    rng = np.random.RandomState(2)
    x = rng.randn(B, S, DR).astype(np.float32)
    w = rng.randn(CW, DR).astype(np.float32)
    bias = rng.randn(DR).astype(np.float32)
    state = rng.randn(B, CW - 1, DR).astype(np.float32) if with_state \
        else None
    valid = None if lengths is None else \
        np.arange(S)[None] < np.asarray(lengths)[:, None]
    jy, js = jax_rglru.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if state is None else jnp.asarray(state),
        valid=None if valid is None else jnp.asarray(valid))
    ty, ts = trglru.causal_conv1d(
        _t(x), _t(w), _t(bias), None if state is None else _t(state),
        valid=None if valid is None else _t(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rglru_step_matches_jax():
    _, jnp, *_, jax_rglru = _jax()
    a, bb, h0 = scan_inputs(3, 1, 40, seed=4)
    want = jax_rglru.rglru_step(jnp.asarray(a[:, 0]), jnp.asarray(bb[:, 0]),
                                jnp.asarray(h0))
    got = trglru.rglru_step(_t(a[:, 0]), _t(bb[:, 0]), _t(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_rglru_block_prefill_then_decode_match_jax():
    """A right-padded prefill (row 1 has 6 real tokens of 10) from a
    non-zero state, then two decode steps from the states it left."""
    _, jnp, *_, jax_rglru = _jax()
    jw, tw = _both(block_weights(seed=5))
    rng = np.random.RandomState(6)
    x = rng.randn(B, S, D).astype(np.float32)
    state = {"h": rng.randn(B, DR).astype(np.float32),
             "conv": rng.randn(B, CW - 1, DR).astype(np.float32)}
    valid = np.arange(S)[None] < np.asarray([S, 6])[:, None]
    jy, js = jax_rglru.rglru_block(
        jnp.asarray(x), jw, H, mode="prefill",
        state={k: jnp.asarray(v) for k, v in state.items()},
        valid=jnp.asarray(valid))
    ty, ts = trglru.rglru_block(_t(x), tw, H, mode="prefill",
                                state={k: _t(v) for k, v in state.items()},
                                valid=_t(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   rtol=TOL, atol=TOL)
    for step in range(2):
        xd = rng.randn(B, 1, D).astype(np.float32)
        jy, js = jax_rglru.rglru_block(jnp.asarray(xd), jw, H, mode="decode",
                                       state=js)
        ty, ts = trglru.rglru_block(_t(xd), tw, H, mode="decode", state=ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(ts["h"].numpy(), np.asarray(js["h"]),
                                   rtol=TOL, atol=TOL)


def test_recurrentgemma_9b_param_count():
    """The full arch's count, layer kind by layer kind, as the JAX
    package counts it."""
    from repro_torch.config import get_arch
    cfg = get_arch("recurrentgemma-9b")
    assert cfg.param_count() == 8578306048
    assert cfg.recurrent_layer_count() == 26
    assert cfg.layer_kinds().count("local") == 12


# ---------------------------------------------------------------------------
# the CUDA kernel (skips without a card)
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _on_card_nan_tailed(x):
    """``x`` on the card, as the front of a longer buffer whose tail is
    NaN: a read past the end of the tensor reaches the output."""
    buf = torch.full((x.size + 4096,), float("nan"), device="cuda")
    buf[:x.size] = _t(x.reshape(-1)).cuda()
    return buf[:x.size].view(x.shape)


# the kernel's ring: kSteps time steps a stage, kStages stages
# (csrc/rglru_scan.cu)
RING_T, RING_K = 64, 4
# (B, S, Dr): one step; fewer steps than a stage; a ring's worth and one
# step either side; a ring wrapped three times and a partial stage; the
# smallest TMA row (Dr = 4) and ragged channel blocks (Dr not a multiple
# of 32); B = 3; and the serving width
CUDA_CASES = [(1, 1, 32), (2, 17, 128), (1, RING_T * RING_K - 1, 256),
              (1, RING_T * RING_K, 256), (2, RING_T * RING_K + 1, 96),
              (1, 3 * RING_T * RING_K + 5, 128), (2, 100, 4), (2, 70, 36),
              (3, 257, 4000), (2, 100, 128), (1, 33, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_kernel_matches_plain_on_card(case, with_h0):
    """Bit for bit: both round each step's multiply and add once."""
    _card()
    a, bb, h0 = scan_inputs(*case, seed=7)
    ad, bd = _on_card_nan_tailed(a), _on_card_nan_tailed(bb)
    hd = _on_card_nan_tailed(h0) if with_h0 else None
    before = cuda_scan.rglru_scan.launches
    got = cuda_scan.rglru_scan(ad, bd, hd)
    torch.cuda.synchronize()
    assert cuda_scan.rglru_scan.launches == before + 1
    want = ref.rglru_scan_ref(ad, bd, hd)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_card():
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    _card()
    a = torch.rand((1, 8, 64), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        cuda_scan.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scan.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="h0"):
        cuda_scan.rglru_scan(a, a, torch.zeros((2, 64), device="cuda"))
    odd = torch.rand((1, 8, 6), device="cuda")
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_scan.rglru_scan(odd, odd)
    # a contiguous view 4 bytes into its storage: no TMA base
    buf = torch.rand((1 + 8 * 64,), device="cuda")
    shifted = buf[1:].view(1, 8, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_scan.rglru_scan(shifted, a)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_gradients_on_card(with_h0):
    """``ops.RGLRUScan`` on the card: a forward and one reversed launch of
    the kernel, da / db / dh0 against the same backward on the CPU (the
    plain loop forward and reversed), which rounds as the kernel does, so
    exactly."""
    _card()
    a, bb, h0 = scan_inputs(2, 300, 256, seed=12)
    dh = np.random.RandomState(13).randn(2, 300, 256).astype(np.float32)
    args = [a, bb, h0] if with_h0 else [a, bb]

    def grads(device):
        leaves = [_t(x).to(device).requires_grad_() for x in args]
        return torch.autograd.grad(ops.rglru_scan(*leaves), leaves,
                                   _t(dh).to(device))

    before = cuda_scan.rglru_scan.launches
    got = grads("cuda")
    torch.cuda.synchronize()
    assert cuda_scan.rglru_scan.launches == before + 2
    for x, w in zip(got, grads("cpu")):
        torch.testing.assert_close(x.cpu(), w, rtol=0, atol=0)
