"""Chunked-prefill attention over the page pool: the router's plain route
and the CUDA kernel (``repro_torch.kernels.chunk_attention``).

On the CPU ``kernels.ops.paged_chunk_attention`` is exactly what the chunk
branch of ``models.model._attn_layer`` computed before the kernel: each
row's whole table gathered and ``models.attention.chunk_attention`` over
it, bit for bit (``tests/test_torch_model.py`` holds that function against
the JAX package's).  The CUDA kernel is compared with that plain version
by the ``cuda``-marked tests, which need the card and skip elsewhere.
This file imports no JAX, so the card can run it (``pytest --noconftest
-m cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

from repro_torch.kernels import chunk_attention as cuda_chunk  # noqa: E402
from repro_torch.kernels import cost, ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# float32, kernel against plain version: the same float32 products summed
# in another order (tiles of 32 keys, an online softmax)
TOL = 1e-5
# bf16, kernel against plain version, as (atol / max|V|, rtol).  Both round
# P to bf16 before P.V, the plain version p = exp(s - m) once at the row's
# final max m, the kernel at its running max and then rescales: each
# rounding is within 2**-9 of p, so a weight differs by at most 2**-8 of
# itself and the weighted mean of V by at most 2**-8 max|V| (the atol).
# Each side then rounds a float32 result to bf16, one ulp apart at most
# (2**-7 of the value, the rtol), as in test_torch_flash_attention.py's
# BF16_TOL.
CHUNK_BF16_TOL = (2 ** -8, 2 ** -7)


def make_case(*, b=2, c=16, g=4, hk=2, dh=64, page=16, max_pages=6,
              offsets=(0, 20), n_valid=None, dtype=torch.float32, seed=0,
              foreign=None):
    """A pool in which each row owns the pages its chunk's positions reach
    (page 0 is scratch); the table's other slots point at other pages
    (``foreign`` ids, or the pool's last pages), all finite.  Returns (q,
    k_pages, v_pages, page_table int32, q_pos int32): a row's positions are
    ``offset + i`` for its first ``n_valid`` queries and -1 after."""
    rng = np.random.RandomState(seed)
    n_valid = [c] * b if n_valid is None else list(n_valid)
    n_pool = 1 + b * max_pages + 2
    pt = np.zeros((b, max_pages), np.int32)
    perm = rng.permutation(np.arange(1, 1 + b * max_pages))
    for r in range(b):
        need = -(-(offsets[r] + n_valid[r]) // page) if n_valid[r] else 0
        assert need <= max_pages
        own = perm[r * max_pages:r * max_pages + need]
        rest = [n_pool - 1 - (r + j) % 2 for j in range(max_pages - need)] \
            if foreign is None else [foreign] * (max_pages - need)
        pt[r] = list(own) + rest
    pos = np.full((b, c), -1, np.int32)
    for r in range(b):
        pos[r, :n_valid[r]] = offsets[r] + np.arange(n_valid[r])
    q = torch.from_numpy(rng.randn(b, c, hk * g, dh).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n_pool, page, hk, dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n_pool, page, hk, dh).astype(np.float32))
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), torch.from_numpy(pt),
            torch.from_numpy(pos))


def gather_then_attend(q, kp, vp, pt, pos):
    """The chunk branch of ``_attn_layer`` as it stood before the kernel."""
    b, _, _, dh = q.shape
    hk = kp.shape[2]
    n_ctx = pt.shape[1] * kp.shape[1]
    ptl = pt.long()
    kg = kp[ptl].reshape(b, n_ctx, hk, dh)
    vg = vp[ptl].reshape(b, n_ctx, hk, dh)
    return attn.chunk_attention(q, kg, vg, torch.arange(n_ctx), pos.long())


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh,page,offsets,n_valid", [
    (1, 64, 16, (0, 20), (16, 16)),
    (8, 128, 16, (3, 32), (16, 9)),          # a partial chunk
    (4, 64, 8, (40, 0), (0, 11)),            # a padding row
    (3, 64, 32, (5, 70), (16, 2)),
])
def test_cpu_route_is_the_gather_and_chunk_attention(g, dh, page, offsets,
                                                     n_valid, dtype):
    q, kp, vp, pt, pos = make_case(g=g, dh=dh, page=page, offsets=offsets,
                                   n_valid=n_valid, dtype=dtype,
                                   max_pages=96 // page)
    before = cuda_chunk.paged_chunk_attention.launches
    got = ops.paged_chunk_attention(q, kp, vp, pt, pos)
    assert torch.equal(got, gather_then_attend(q, kp, vp, pt, pos))
    assert got.dtype == dtype and got.shape == q.shape
    assert cuda_chunk.paged_chunk_attention.launches == before


def test_plain_gives_a_padded_query_the_mean_of_v_over_the_table():
    """The value the kernel copies for padded queries: every slot masked,
    so p = 1 on each of the T slots and the output is V's mean over the
    row's whole table (the tokens of a MoE layer's padded rows take expert
    capacity, so it matters there)."""
    q, kp, vp, pt, pos = make_case(offsets=(0, 8), n_valid=(16, 5), g=2)
    out = ops.paged_chunk_attention(q, kp, vp, pt, pos)
    n_ctx = pt.shape[1] * kp.shape[1]
    mean = vp[pt[1].long()].reshape(n_ctx, 2, 64).mean(0)    # (Hk, Dh)
    want = mean.repeat_interleave(2, dim=0)                   # (H, Dh)
    for i in range(5, 16):
        torch.testing.assert_close(out[1, i], want, rtol=1e-5, atol=1e-6)


def test_plain_clamps_page_ids_to_the_pool():
    """Slots past a row's pages with ids outside the pool read the pool's
    last (negative: first) page, as the kernel reads them."""
    q, kp, vp, pt, pos = make_case(offsets=(0, 0), n_valid=(16, 3),
                                   foreign=10 ** 6)
    got = ops.paged_chunk_attention(q, kp, vp, pt, pos)
    clamped = pt.clamp(0, kp.shape[0] - 1)
    assert torch.equal(got, gather_then_attend(q, kp, vp, clamped, pos))
    low = pt.clone()
    low[low == 10 ** 6] = -7
    assert torch.equal(ops.paged_chunk_attention(q, kp, vp, low, pos),
                       gather_then_attend(q, kp, vp, low.clamp(min=0), pos))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    args = make_case()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_chunk.paged_chunk_attention(*args)


@pytest.mark.parametrize("bad,match", [
    ("window", "window"),
    ("dtype", "dtype"),
    ("mixed", "share one dtype"),
    ("int64_table", "int32"),
    ("int64_pos", "int32"),
    ("head_dim", "head_dim"),
    ("heads", "multiple"),
    ("page", "page size"),
    ("pos_shape", "q_pos"),
    ("wide_table", "wider"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(bad, match):
    q, kp, vp, pt, pos = make_case()
    window = 0
    if bad == "window":
        window = 4
    elif bad == "dtype":
        q, kp, vp = (t.half() for t in (q, kp, vp))
    elif bad == "mixed":
        kp = kp.bfloat16()
    elif bad == "int64_table":
        pt = pt.long()
    elif bad == "int64_pos":
        pos = pos.long()
    elif bad == "head_dim":
        q, kp, vp = q[..., :48], kp[..., :48], vp[..., :48]
    elif bad == "heads":
        q = q[:, :, :7]
    elif bad == "page":
        kp, vp = kp[:, :12], vp[:, :12]
    elif bad == "pos_shape":
        pos = pos[:, :5]
    elif bad == "wide_table":
        pt = torch.zeros((2, cuda_chunk.MAX_TABLE_PAGES + 1),
                         dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        cuda_chunk.paged_chunk_attention(q, kp, vp, pt, pos, window=window)


def test_chunk_cost_counts_real_pairs_and_padded_means():
    """A real query at position p sees min(p + 1, T) slots, a padded one
    takes V's mean over all T; bytes read K to the last real position and
    V to the table's end where a query is padded."""
    flops, nbytes = cost.chunk_cost([[3, 4, -1]], h=4, hk=2, dh=8, esize=2,
                                    max_pages=2, page=4)
    assert flops == 4 * 4 * 8 * (4 + 5) + 2 * 4 * 8 * 8
    assert nbytes == (5 + 8) * 2 * 8 * 2 + 2 * 3 * 4 * 8 * 2 + 2 * 4 + 3 * 4
    flops, _ = cost.chunk_cost([[100]], h=1, hk=1, dh=8, esize=2,
                               max_pages=2, page=4)
    assert flops == 4 * 8 * 8                # capped at the table's T = 8


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _check(q, kp, vp, pt, pos, *, launches=1):
    """The kernel on the card against the plain version of the same
    inputs, within the dtype's tolerance."""
    dev = torch.device("cuda")
    qd, kd, vd, ptd, posd = (t.to(dev) for t in (q, kp, vp, pt, pos))
    before = cuda_chunk.paged_chunk_attention.launches
    got = cuda_chunk.paged_chunk_attention(qd, kd, vd, ptd, posd)
    torch.cuda.synchronize()
    assert cuda_chunk.paged_chunk_attention.launches == before + launches
    want = ref.paged_chunk_attention_ref(qd, kd, vd, ptd, posd)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    if q.dtype == torch.float32:
        atol, rtol = TOL, TOL
    else:
        atol = CHUNK_BF16_TOL[0] * vp.float().abs().max().item()
        rtol = CHUNK_BF16_TOL[1]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# yi-9b's chunk (C 256, Hk 4, G 8, Dh 128, page 16) in a 64-page table:
# offsets 0, inside a page, on a page edge, and the chunk reaching the
# table's last slot (1024 - 256)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offsets", [(0, 5), (16, 512), (768, 333)])
def test_kernel_at_yi9b_chunk_on_card(offsets, dtype):
    _card()
    _check(*make_case(b=2, c=256, g=8, hk=4, dh=128, page=16, max_pages=64,
                      offsets=offsets, dtype=dtype, seed=1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_with_partial_chunks_and_padding_rows_on_card(dtype):
    """A full row, two partial chunks (one ending inside a query tile) and
    a padding row: padded queries get V's mean over their whole table."""
    _card()
    _check(*make_case(b=4, c=256, g=8, hk=4, dh=128, page=16, max_pages=40,
                      offsets=(100, 0, 300, 0), n_valid=(256, 37, 130, 0),
                      dtype=dtype, seed=2))


# every G the main path meets (3 and 6 through kernels.groups) and both
# other head dims, at small chunks and tables that are not multiples of the
# 64-key tile
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,dh,page,launches", [
    (1, 64, 16, 1), (3, 128, 16, 1), (4, 128, 8, 1), (6, 64, 32, 1),
    (16, 256, 16, 1), (8, 256, 64, 1), (2, 64, 128, 1), (24, 64, 16, 2)])
def test_kernel_takes_every_group_and_head_dim_on_card(g, dh, page, launches,
                                                       dtype):
    _card()
    max_pages = max(2, 200 // page + 1)
    _check(*make_case(b=2, c=40, g=g, hk=2, dh=dh, page=page,
                      max_pages=max_pages, offsets=(0, 150),
                      n_valid=(40, 23), dtype=dtype, seed=3),
           launches=launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("foreign", [10 ** 6, -3])
def test_kernel_clamps_page_ids_on_card(foreign, dtype):
    """Ids past the pool (or negative) in a table's unused slots: a padded
    query reads them as the pool's last (first) page, as the plain version
    does; real queries never reach them."""
    _card()
    _check(*make_case(b=2, c=64, g=4, hk=2, dh=128, page=16, max_pages=12,
                      offsets=(10, 0), n_valid=(64, 20), dtype=dtype,
                      seed=4, foreign=foreign))
