"""Flash attention of the PyTorch port against the JAX package.

The port's plain version (``repro_torch.kernels.ref.flash_attention_ref``)
is held against the JAX Pallas kernel run as ``tests/test_kernels.py`` runs
it (``interpret=True``) and against ``repro.models.attention.flash_attention``,
on the same numpy inputs.  Tolerance ``atol = rtol = 1e-5`` in float32: the
JAX functions sum per block of keys with an online softmax, the plain
version over the whole row, so only the summation order differs.  The CUDA
kernel itself is compared with the plain version by the ``cuda``-marked
tests, which need the card and skip elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as cuda_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
# the CUDA kernel against the plain version in bf16, (atol, rtol): both
# compute in float32 (the kernel keeps P in float32 too) and round once to
# bf16, so they differ by at most one bf16 ulp (2**-7 of the value); atol
# covers float32 summation order near zero
BF16_TOL = (1e-5, 2 ** -7)

# (G, Dh, Sq, Skv, causal, window): both group layouts of the reduced
# models and the serving shapes, ragged lengths that are not multiples of
# the 8-row blocks below, and Sq != Skv in both directions.  Every query
# sees at least one key (see ``flash_attention_ref`` on empty rows).
CASES = [
    (1, 16, 13, 13, True, 0),
    (2, 64, 21, 21, True, 5),
    (4, 16, 11, 19, True, 0),
    (4, 64, 11, 19, True, 5),
    (1, 64, 19, 11, False, 0),
    (2, 16, 13, 22, False, 5),
    (16, 64, 21, 21, True, 5),      # recurrentgemma: 16 heads, 1 kv head
    (16, 16, 11, 19, False, 0),
]


def make_inputs(g, dh, sq, skv, *, seed=0, hk=2, b=2, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, hk * g, dh).astype(dtype)
    k = rng.randn(b, skv, hk, dh).astype(dtype)
    v = rng.randn(b, skv, hk, dh).astype(dtype)
    return q, k, v


def _jax():
    """The JAX package's side, imported per test: the machine with the
    card has no JAX, and the ``cuda`` tests must still collect there
    (``pytest --noconftest -m cuda``)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models import attention as jax_attn
    return jnp, flash_attention_pallas, jax_attn


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_kernel(case):
    jnp, pallas_flash, _ = _jax()
    g, dh, sq, skv, causal, window = case
    q, k, v = make_inputs(g, dh, sq, skv)
    want = np.asarray(pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_blk=8, kv_blk=8, interpret=True))
    got = ref.flash_attention_ref(*_torch(q, k, v), causal=causal,
                                  window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference(case):
    jnp, _, jax_attn = _jax()
    g, dh, sq, skv, causal, window = case
    # the jnp function's windowed path (``_windowed_attention``) is causal
    # whatever ``causal`` says, where the Pallas kernel honours it: a
    # non-causal windowed case is held to the kernel above, and here to
    # its causal form
    causal = causal or window > 0
    q, k, v = make_inputs(g, dh, sq, skv, seed=1)
    want = np.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=8, kv_chunk=8))
    got = ref.flash_attention_ref(*_torch(q, k, v), causal=causal,
                                  window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_gives_zeros_where_a_query_sees_no_key():
    """Causal, Sq > Skv + window: the last queries see no key at all."""
    q, k, v = _torch(*make_inputs(2, 16, 20, 9))
    out = ref.flash_attention_ref(q, k, v, causal=True, window=4)
    assert (out[:, 12:] == 0).all()          # query 12 needs a key > 8
    assert torch.isfinite(out).all() and (out[:, :12] != 0).any()


def test_router_takes_plain_version_on_cpu():
    q, k, v = _torch(*make_inputs(2, 64, 16, 16, seed=3))
    before = cuda_flash.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True, window=5)
    np.testing.assert_array_equal(
        out.numpy(),
        ref.flash_attention_ref(q, k, v, causal=True, window=5).numpy())
    assert cuda_flash.flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    q, k, v = _torch(*make_inputs(2, 64, 16, 16, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash.flash_attention(q, k, v)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# (G, Dh, Sq, Skv, causal, window) on the card: every head dim and group
# size the kernel takes, ragged tiles, Sq != Skv, windows across tiles
CUDA_CASES = [
    (1, 64, 13, 13, True, 0),
    (2, 256, 100, 100, True, 0),
    (2, 256, 150, 150, True, 40),
    (4, 128, 70, 45, False, 0),
    (8, 64, 33, 80, True, 17),
    (8, 256, 40, 40, False, 9),
    (16, 256, 100, 100, True, 40),   # recurrentgemma's local layers
    (16, 64, 70, 45, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_kernel_matches_plain_on_card(case, dtype):
    _card()
    g, dh, sq, skv, causal, window = case
    q, k, v = make_inputs(g, dh, sq, skv, seed=5, b=1)
    tdt = getattr(torch, dtype)
    # k/v are the first Skv rows of longer tensors whose tail is NaN: a
    # read past Skv would reach the output
    big_k = torch.full((1, skv + 64) + k.shape[2:], float("nan"))
    big_v = big_k.clone()
    big_k[:, :skv], big_v[:, :skv] = _torch(k, v)
    qd = _torch(q)[0].cuda().to(tdt)
    kd, vd = big_k.cuda().to(tdt)[:, :skv], big_v.cuda().to(tdt)[:, :skv]
    before = cuda_flash.flash_attention.launches
    got = cuda_flash.flash_attention(qd, kd, vd, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert cuda_flash.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(qd, kd, vd, causal=causal, window=window)
    atol, rtol = (TOL, TOL) if dtype == "float32" else BF16_TOL
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [3, 6, 24])
def test_kernel_takes_any_group_size_on_card(g, dtype):
    """A G the kernel is not built for: zero-padded groups (G = 3, 6) and
    launches of 16 (G = 24), one counted launch each, pad rows dropped."""
    _card()
    q, k, v = make_inputs(g, 128, 70, 70, seed=6, b=1)
    tdt = getattr(torch, dtype)
    qd, kd, vd = (t[0].cuda().to(tdt) for t in (_torch(q), _torch(k),
                                                _torch(v)))
    before = cuda_flash.flash_attention.launches
    got = cuda_flash.flash_attention(qd, kd, vd, causal=True, window=33)
    torch.cuda.synchronize()
    assert cuda_flash.flash_attention.launches == before + \
        len(cuda_flash.groups.group_plan(g, cuda_flash.GROUP_SIZES))
    want = ref.flash_attention_ref(qd, kd, vd, causal=True, window=33)
    atol, rtol = (TOL, TOL) if dtype == "float32" else BF16_TOL
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_card():
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    _card()
    q, k, v = [t.cuda() for t in _torch(*make_inputs(2, 16, 16, 16))]
    with pytest.raises(ValueError, match="head_dim"):
        cuda_flash.flash_attention(q, k, v)
    q, k, v = [t.cuda() for t in _torch(*make_inputs(2, 64, 4, 16))]
    with pytest.raises(ValueError, match="at least"):
        cuda_flash.flash_attention(q, k, v)


# the bf16 kernel's tile edges: a block holds 128 score rows (128 / G
# positions) and a kv tile 64 keys, so Sq and Skv of 127, 128 and 129 end
# a tile one short, exactly, or one over, at G = 1 (128 positions a block)
# and G = 16 (8 positions a block)
EDGE = (127, 128, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("skv", EDGE)
@pytest.mark.parametrize("sq", EDGE)
@pytest.mark.parametrize("g", [1, 16])
def test_kernel_at_tile_edges_on_card(g, sq, skv):
    _card()
    dh = 128 if g == 1 else 256
    q, k, v = make_inputs(g, dh, sq, skv, seed=9, hk=1, b=2)
    # batch 2: the second row's K/V follow the first's in memory, so only
    # the per-row bounds of the tensor maps keep a tile from reading them
    qd, kd, vd = [t.cuda().to(torch.bfloat16) for t in _torch(q, k, v)]
    for causal, window in ((True, 0), (False, 0), (True, 50)):
        got = cuda_flash.flash_attention(qd, kd, vd, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(qd, kd, vd, causal=causal,
                                       window=window)
        assert torch.isfinite(got.float()).all()
        atol, rtol = BF16_TOL
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
