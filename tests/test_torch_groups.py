"""Query-group regrouping of the port's attention wrappers
(``repro_torch.kernels.groups``): any GQA group size G runs through
kernels instantiated for a few, with zero query rows padding each group
and launches of at most the largest size.  On the CPU the plain versions
stand in for the kernels: split, attend each launch, merge must equal one
plain call on the whole group (float32, ``atol = rtol = 1e-6``: the two
sum over the same keys in the same order but in batches of another
shape), and the pad rows must be dropped.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as cuda_flash  # noqa: E402
from repro_torch.kernels import groups, ref  # noqa: E402
from repro_torch.kernels import paged_attention as cuda_paged  # noqa: E402

TOL = 1e-6
PAGED = cuda_paged.GROUP_SIZES          # (1, 2, 4, 8)
FLASH = cuda_flash.GROUP_SIZES          # (1, 2, 4, 8, 16)


@pytest.mark.parametrize("g,sizes,want", [
    (4, PAGED, [(0, 4, 4)]),
    (3, PAGED, [(0, 3, 4)]),
    (6, PAGED, [(0, 6, 8)]),
    (16, PAGED, [(0, 8, 8), (8, 8, 8)]),
    (12, PAGED, [(0, 8, 8), (8, 4, 4)]),
    (19, PAGED, [(0, 8, 8), (8, 8, 8), (16, 3, 4)]),
    (3, FLASH, [(0, 3, 4)]),
    (6, FLASH, [(0, 6, 8)]),
    (16, FLASH, [(0, 16, 16)]),
    (24, FLASH, [(0, 16, 16), (16, 8, 8)]),
    (40, FLASH, [(0, 16, 16), (16, 16, 16), (32, 8, 8)]),
])
def test_group_plan(g, sizes, want):
    plan = groups.group_plan(g, sizes)
    assert plan == want
    assert sum(n for _, n, _ in plan) == g
    assert all(p in sizes and p >= n for _, n, p in plan)


def test_group_plan_refuses_an_empty_group():
    with pytest.raises(ValueError):
        groups.group_plan(0, PAGED)


@pytest.mark.parametrize("g", [1, 3, 5, 6, 12, 16, 24])
@pytest.mark.parametrize("head_axis,shape", [(1, (3, None, 8)),
                                             (2, (2, 5, None, 8))])
def test_split_pads_with_zeros_and_merge_drops_them(g, head_axis, shape):
    hk = 2
    shape = tuple(hk * g if d is None else d for d in shape)
    q = torch.randn(shape, generator=torch.Generator().manual_seed(g))
    plan = groups.group_plan(g, PAGED)
    parts = groups.split_groups(q, hk, plan, head_axis)
    assert len(parts) == len(plan)
    for part, (start, n, padded) in zip(parts, plan):
        assert part.is_contiguous() and part.shape[head_axis] == hk * padded
        pg = part.unflatten(head_axis, (hk, padded))
        qg = q.unflatten(head_axis, (hk, g))
        assert torch.equal(pg.narrow(head_axis + 1, 0, n),
                           qg.narrow(head_axis + 1, start, n))
        assert (pg.narrow(head_axis + 1, n, padded - n) == 0).all()
    # outputs shaped as the launches' queries: merge restores q exactly
    assert torch.equal(groups.merge_groups(parts, hk, plan, head_axis), q)


def _paged_inputs(g, hk=2, dh=16, page=8, max_pages=4, lens=(0, 5, 29)):
    rng = np.random.RandomState(g)
    b = len(lens)
    n_pool = 1 + b * max_pages
    q = torch.from_numpy(rng.randn(b, hk * g, dh).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n_pool, page, hk, dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n_pool, page, hk, dh).astype(np.float32))
    pt = torch.arange(1, 1 + b * max_pages, dtype=torch.int32).view(
        b, max_pages)
    return q, kp, vp, pt, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("g", [3, 5, 6, 12, 16])
@pytest.mark.parametrize("window", [0, 11])
def test_regrouped_paged_attention_equals_one_plain_call(g, window):
    q, kp, vp, pt, lens = _paged_inputs(g)
    plan = groups.group_plan(g, PAGED)
    outs = [ref.paged_decode_attention_ref(qi, kp, vp, pt, lens,
                                           window=window)
            for qi in groups.split_groups(q, 2, plan, 1)]
    got = groups.merge_groups(outs, 2, plan, 1)
    want = ref.paged_decode_attention_ref(q, kp, vp, pt, lens, window=window)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("g", [3, 6, 12, 24])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 9)])
def test_regrouped_flash_attention_equals_one_plain_call(g, causal, window):
    gen = torch.Generator().manual_seed(g)
    q = torch.randn((2, 21, 2 * g, 16), generator=gen)
    k = torch.randn((2, 30, 2, 16), generator=gen)
    v = torch.randn((2, 30, 2, 16), generator=gen)
    plan = groups.group_plan(g, FLASH)
    outs = [ref.flash_attention_ref(qi, k, v, causal=causal, window=window)
            for qi in groups.split_groups(q, 2, plan, 2)]
    got = groups.merge_groups(outs, 2, plan, 2)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
