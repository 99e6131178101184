"""Paged decode attention of the PyTorch port against the JAX package.

The port's plain version (``repro_torch.kernels.ref``) is held against the
JAX Pallas kernel run as ``tests/test_kernels.py`` runs it
(``interpret=True``) and against ``repro.kernels.ref``, on the same numpy
inputs.  Tolerance ``atol = rtol = 1e-5`` in float32: the Pallas kernel
sums per block of pages, so the summation order differs.  The CUDA kernel
itself is compared with the plain version by the ``cuda``-marked test,
which needs the card and skips elsewhere.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as cuda_paged  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
# the CUDA kernel against the plain version in bf16, (atol, rtol): both
# compute in float32 and round once to bf16, so they differ by at most one
# bf16 ulp (2**-7 of the value); atol covers float32 summation order
BF16_TOL = (1e-5, 2 ** -7)

# (G, Dh, page, window): both group sizes the main path cares about (1, 8),
# every head dim (256: gemma3's global layers), both page sizes, with and
# without a sliding window
CASES = [
    (1, 64, 8, 0),
    (8, 128, 16, 0),
    (8, 64, 16, 20),
    (1, 128, 8, 13),
    (2, 256, 16, 0),
]


def make_inputs(g, dh, page, *, seed=0, hk=2, max_pages=4,
                lens=(0, 5, 29), dtype=np.float32):
    """Disjoint per-row page ranges (page 0 is scratch).  Table slots past
    a row's last valid page point at *foreign* pages; the ``_bad`` copies
    of the pools hold NaN in every page no row owns.  (The unused tail of
    a row's own last page stays clean here: the TPU kernel reads it and
    masks after the dot, so NaN there would reach its output.)"""
    rng = np.random.RandomState(seed)
    b = len(lens)
    n_pool = 1 + b * max_pages + 2
    q = rng.randn(b, hk * g, dh).astype(dtype)
    kp = rng.randn(n_pool, page, hk, dh).astype(dtype)
    vp = rng.randn(n_pool, page, hk, dh).astype(dtype)
    pt = np.zeros((b, max_pages), np.int32)
    seq = np.asarray(lens, np.int32)
    owned = {}
    for r in range(b):
        n_pages = -(-int(seq[r]) // page)
        own = list(range(1 + r * max_pages, 1 + r * max_pages + n_pages))
        foreign = [n_pool - 1 - (r + j) % 2 for j in range(max_pages)]
        pt[r] = (own + foreign)[:max_pages]
        for j, p in enumerate(own):
            owned[p] = min(page, int(seq[r]) - j * page)
    kp_bad, vp_bad = kp.copy(), vp.copy()
    for p in range(n_pool):
        if p not in owned:
            kp_bad[p] = np.nan
            vp_bad[p] = np.nan
    return q, kp, vp, pt, seq, kp_bad, vp_bad


def poison_tails(kp, vp, pt, seq):
    """Copies that also hold NaN in every slot past each row's last token
    (the unused tail of its last page)."""
    kp, vp = kp.copy(), vp.copy()
    page = kp.shape[1]
    for r, n in enumerate(seq):
        if n % page:
            kp[pt[r, n // page], n % page:] = np.nan
            vp[pt[r, n // page], n % page:] = np.nan
    return kp, vp


def _jax_side():
    """The JAX package's side, imported per test: the machine with the
    card has no JAX, and its ``cuda`` test must still collect there
    (``pytest --noconftest -m cuda``)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jax_ref
    from repro.kernels.paged_attention import paged_decode_attention
    return jnp, jax_ref, paged_decode_attention


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_kernel(case):
    jnp, _, pallas_paged = _jax_side()
    g, dh, page, window = case
    q, kp, vp, pt, seq, kp_bad, vp_bad = make_inputs(g, dh, page)
    want = np.asarray(pallas_paged(
        jnp.asarray(q), jnp.asarray(kp_bad), jnp.asarray(vp_bad),
        jnp.asarray(pt), jnp.asarray(seq), window=window, interpret=True))
    got = ref.paged_decode_attention_ref(*_torch(q, kp_bad, vp_bad, pt, seq),
                                         window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # a seq_len == 0 row reads nothing and is exact zeros, as the TPU
    # kernel's 0 / max(0, 1e-30)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference(case):
    """Against the JAX gather-then-attend oracle on clean pools (that
    oracle multiplies masked slots by zero, so it is not NaN-proof) and
    rows with tokens.  NaN in foreign pages, or in the unused tail of a
    row's own last page, must not change the port's output by a bit."""
    jnp, jax_ref, _ = _jax_side()
    g, dh, page, window = case
    q, kp, vp, pt, seq, kp_bad, vp_bad = make_inputs(g, dh, page, seed=1,
                                                     lens=(3, 17, 32))
    want = np.asarray(jax_ref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(seq), window=window))
    got = ref.paged_decode_attention_ref(*_torch(q, kp, vp, pt, seq),
                                         window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for bad_k, bad_v in ((kp_bad, vp_bad),
                         poison_tails(kp_bad, vp_bad, pt, seq)):
        got_bad = ref.paged_decode_attention_ref(
            *_torch(q, bad_k, bad_v, pt, seq), window=window).numpy()
        np.testing.assert_array_equal(got, got_bad)


def test_page_ids_are_clamped_to_the_pool():
    """Out-of-range table entries clamp to [0, P-1], as the TPU kernel's
    wrapper does (``paged_attention.py:172``)."""
    jnp, _, pallas_paged = _jax_side()
    q, kp, vp, pt, seq, _, _ = make_inputs(2, 64, 8, seed=2, lens=(9, 20))
    n_pool = kp.shape[0]
    wild = pt.copy()
    wild[:, -1] = n_pool + 7            # past the pool: clamps to P-1
    wild[0, 1:] = -3                    # below it: clamps to page 0
    seq = np.asarray([9, 32], np.int32)
    want = np.asarray(pallas_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(wild),
        jnp.asarray(seq), interpret=True))
    got = ref.paged_decode_attention_ref(*_torch(q, kp, vp, wild, seq)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_router_takes_plain_version_on_cpu():
    q, kp, vp, pt, seq, _, _ = make_inputs(8, 128, 16, seed=3)
    before = cuda_paged.paged_decode_attention.launches
    args = _torch(q, kp, vp, pt, seq)
    out = ops.paged_decode_attention(*args, window=7)
    np.testing.assert_array_equal(
        out.numpy(), ref.paged_decode_attention_ref(*args, window=7).numpy())
    assert cuda_paged.paged_decode_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    q, kp, vp, pt, seq, _, _ = make_inputs(2, 64, 8, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_paged.paged_decode_attention(*_torch(q, kp, vp, pt, seq))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g, dh, page, window = case
    q, kp, vp, pt, seq, kp_bad, vp_bad = make_inputs(g, dh, page, seed=5)
    kp_bad, vp_bad = poison_tails(kp_bad, vp_bad, pt, seq)
    tdt = getattr(torch, dtype)
    args = [t.cuda() for t in _torch(q, kp_bad, vp_bad, pt, seq)]
    args[:3] = [t.to(tdt) for t in args[:3]]
    before = cuda_paged.paged_decode_attention.launches
    got = cuda_paged.paged_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert cuda_paged.paged_decode_attention.launches == before + 1
    want = ref.paged_decode_attention_ref(*args, window=window)
    atol, rtol = (TOL, TOL) if dtype == "float32" else BF16_TOL
    assert torch.isfinite(got.float()).all()
    assert (got[0] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [3, 6, 12, 16])
def test_kernel_takes_any_group_size_on_card(g, dtype):
    """A G the kernel is not built for: zero-padded groups (G = 3, 6) and
    launches of 8 (G = 12, 16), one counted launch each, pad rows
    dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, kp, vp, pt, seq, kp_bad, vp_bad = make_inputs(g, 128, 16, seed=7)
    kp_bad, vp_bad = poison_tails(kp_bad, vp_bad, pt, seq)
    tdt = getattr(torch, dtype)
    args = [t.cuda() for t in _torch(q, kp_bad, vp_bad, pt, seq)]
    args[:3] = [t.to(tdt) for t in args[:3]]
    before = cuda_paged.paged_decode_attention.launches
    got = cuda_paged.paged_decode_attention(*args, window=0)
    torch.cuda.synchronize()
    assert cuda_paged.paged_decode_attention.launches == before + \
        len(cuda_paged.groups.group_plan(g, cuda_paged.GROUP_SIZES))
    want = ref.paged_decode_attention_ref(*args, window=0)
    atol, rtol = (TOL, TOL) if dtype == "float32" else BF16_TOL
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_clamps_page_ids_on_card(dtype):
    """Out-of-pool page ids in a row's live slots clamp to [0, P-1] in the
    kernel exactly as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, kp, vp, pt, seq, _, _ = make_inputs(8, 128, 16, seed=6, lens=(9, 40))
    wild = pt.copy()
    wild[0, 0], wild[1, 1] = kp.shape[0] + 3, -2
    tdt = getattr(torch, dtype)
    args = [t.cuda() for t in _torch(q, kp, vp, wild, seq)]
    args[:3] = [t.to(tdt) for t in args[:3]]
    got = cuda_paged.paged_decode_attention(*args)
    want = ref.paged_decode_attention_ref(*args)
    atol, rtol = (TOL, TOL) if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# split-KV: the wrapper's plan, and the split-and-merge the kernel runs
# ---------------------------------------------------------------------------

# (max_pages, page_size, pairs, n_sm): yi-9b's kernel-check and serve
# tables, gemma3-12b's, a small sweep shape, and one split
PLANS = [(128, 16, 64, 132), (64, 16, 64, 132), (136, 16, 128, 132),
         (8, 8, 8, 132), (4, 16, 4, 1), (37, 32, 3, 132), (4096, 8, 1, 132),
         (3000, 8, 2000, 132)]


def split_pages(seq_len, window, split, pages, page, max_pages):
    """The table slots that split ``split`` of a row reads."""
    begin, end = cuda_paged.split_token_range(seq_len, window, split, pages,
                                              page, max_pages)
    return list(range(begin // page, (end - 1) // page + 1)) \
        if end > begin else []


@pytest.mark.parametrize("plan", PLANS)
def test_split_plan_covers_every_page_once(plan):
    """Every page that holds a token of ``[lo, seq_len)`` is read by
    exactly one split, in whole pages, and no other page is read: ragged
    lengths, ``seq_len == 0``, a full table, windows that start inside a
    split, and the one-split plan."""
    max_pages, page, pairs, n_sm = plan
    pages, n_split = cuda_paged.split_plan(max_pages, page, pairs, n_sm)
    assert 1 <= pages <= min(max_pages, cuda_paged.MAX_SPLIT_PAGES)
    assert n_split * pages >= max_pages > (n_split - 1) * pages
    assert n_split <= cuda_paged.MAX_SPLITS
    # at least 2 blocks an SM, as far as the split granularity allows
    unit = max(1, cuda_paged.SPLIT_TOKENS // page)
    assert n_split >= min(-(-2 * n_sm // pairs), -(-max_pages // unit),
                          cuda_paged.MAX_SPLITS)
    span = pages * page
    lens = [0, 1, span - 1, span, span + 1, max_pages * page,
            max_pages * page - page // 2, 3 * span // 2]
    for seq_len in lens:
        seq_len = min(seq_len, max_pages * page)
        for window in (0, 1, page + 3, span // 2 + 5, 10 ** 6):
            lo = max(seq_len - window, 0) if window else 0
            want = list(range(lo // page, -(-seq_len // page)))
            got = []
            for s in range(n_split):
                begin, end = cuda_paged.split_token_range(
                    seq_len, window, s, pages, page, max_pages)
                read = split_pages(seq_len, window, s, pages, page,
                                   max_pages)
                if end > begin:
                    # a split's tokens lie inside its own whole pages
                    assert s * span <= begin < end <= (s + 1) * span
                    assert read[0] >= s * pages
                    assert read[-1] < (s + 1) * pages
                got += read
            assert got == want, (seq_len, window)


def split_merge(q, kp, vp, pt, seq, window, pages, n_split):
    """The kernel's algorithm as plain float32 PyTorch: per split the
    partial ``(m, l, o)`` of its tokens in base-2 units (``m = NEG_INF, l =
    0, o = 0`` for an empty split), then the merge of the partials."""
    b, h, dh = q.shape
    n_pool, page, hk, _ = kp.shape
    g = h // hk
    scale = math.log2(math.e) / math.sqrt(dh)
    out = torch.zeros((b, h, dh), dtype=torch.float32)
    for r in range(b):
        for kv in range(hk):
            qg = q[r, kv * g:(kv + 1) * g].float()
            parts = []
            for s in range(n_split):
                begin, end = cuda_paged.split_token_range(
                    int(seq[r]), window, s, pages, page, pt.shape[1])
                if end <= begin:
                    parts.append((torch.full((g,), ref.NEG_INF),
                                  torch.zeros(g), torch.zeros(g, dh)))
                    continue
                t = torch.arange(begin, end)
                pid = pt[r, t // page].long().clamp(0, n_pool - 1)
                kk = kp[pid, t % page, kv].float()
                vv = vp[pid, t % page, kv].float()
                sc = (qg @ kk.T) * scale
                m = sc.amax(-1)
                p = torch.exp2(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ vv))
            m_all = torch.stack([p[0] for p in parts])       # (n_split, g)
            m = m_all.amax(0)
            f = torch.exp2(m_all - m)
            l = sum(p[1] * f[i] for i, p in enumerate(parts))
            o = sum(p[2] * f[i][:, None] for i, p in enumerate(parts))
            out[r, kv * g:(kv + 1) * g] = o / l.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("window", [0, 23])
@pytest.mark.parametrize("g", [1, 8])
def test_split_merge_matches_plain(g, window):
    """Split, then merge, as the kernel does, equals the plain version
    within float32 1e-6: ragged rows, a zero-length row, rows that leave
    most splits empty, and a row that fills the table."""
    page, max_pages = 16, 12
    q, kp, vp, pt, seq, _, _ = make_inputs(
        g, 64, page, seed=7, max_pages=max_pages,
        lens=(0, 5, 29, 70, 130, 192))
    pages, n_split = cuda_paged.split_plan(max_pages, page, 12, 132)
    assert n_split == 3
    args = _torch(q, kp, vp, pt, seq)
    got = split_merge(*args, window, pages, n_split)
    want = ref.paged_decode_attention_ref(*args, window=window)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (got[0] == 0).all()


# (G, Dh, lengths): seq_len at a split boundary and one token either side,
# and one row far longer than the rest (most of the others' splits empty)
SPLIT_EDGE_CASES = [(8, 128, "boundary"), (1, 64, "boundary"),
                    (2, 256, "boundary"), (8, 128, "one-long"),
                    (4, 256, "one-long")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SPLIT_EDGE_CASES)
def test_kernel_at_split_edges_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g, dh, kind = case
    page, max_pages, hk = 16, 128, 2
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    pages, n_split = cuda_paged.split_plan(max_pages, page, 5 * hk, n_sm)
    assert n_split > 1
    span = pages * page
    lens = ((0, span - 1, span, span + 1, 2 * span + 1) if kind == "boundary"
            else (3, 17, max_pages * page, 1, 40))
    q, kp, vp, pt, seq, kp_bad, vp_bad = make_inputs(
        g, dh, page, seed=8, hk=hk, max_pages=max_pages, lens=lens)
    kp_bad, vp_bad = poison_tails(kp_bad, vp_bad, pt, seq)
    tdt = getattr(torch, dtype)
    args = [t.cuda() for t in _torch(q, kp_bad, vp_bad, pt, seq)]
    args[:3] = [t.to(tdt) for t in args[:3]]
    atol, rtol = (TOL, TOL) if dtype == "float32" else BF16_TOL
    for window in (0, span // 2 + 3):
        got = cuda_paged.paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(*args, window=window)
        assert torch.isfinite(got.float()).all()
        assert (got[args[4] == 0] == 0).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)


def test_split_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="positive"):
        cuda_paged.split_plan(0, 16, 4, 132)
    too_wide = cuda_paged.MAX_SPLITS * cuda_paged.MAX_SPLIT_PAGES + 1
    with pytest.raises(ValueError, match="wider"):
        cuda_paged.split_plan(too_wide, 16, 4, 132)
