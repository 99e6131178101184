"""The traffic generator: the same seed gives the same requests, every
seed the same sizes, and the first batch-full is drawn from the
residual-life distribution."""

from collections import Counter

import numpy as np
import pytest

from bench import spec
from bench import traffic as T

MIXES = ("decode_heavy", "prefill_heavy")


def mix(name):
    return spec.read_json(spec.BENCH / "traffic" / f"{name}.json")


def take(stream, n):
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    seed = 2**31 + 7
    a = take(T.Stream(mix(name), seed, 64000, 16), 300)
    b = take(T.Stream(mix(name), seed, 64000, 16), 300)
    for x, y in zip(a, b):
        assert x.max_new == y.max_new and x.greedy == y.greedy
        assert np.array_equal(x.prompt, y.prompt)
    c = take(T.Stream(mix(name), seed + 1, 64000, 16), 300)
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_sizes(name):
    m = mix(name)
    n = m["deck"]
    rows = 4
    sizes = []
    for seed in (1, 99, 2**33 + 5):
        reqs = take(T.Stream(m, seed, 1000, rows), rows + n)[rows:]
        # after the first batch-full: one deck pass, in the seed's order,
        # less the ``rows`` cards the first batch took
        sizes.append(Counter((len(r.prompt), r.greedy)
                             for r in reqs[:n - rows]))
    full = Counter((p, g) for p, _, g in T.deck(m))
    for s in sizes:
        assert not (s - full)


@pytest.mark.parametrize("name", MIXES)
def test_deck_matches_the_mix(name):
    m = mix(name)
    d = T.deck(m)
    prompts = np.array([p for p, _, _ in d])
    outs = np.array([o for _, o, _ in d])
    assert prompts.min() >= m["prompt"]["lo"]
    assert prompts.max() <= m["prompt"]["hi"]
    assert outs.min() >= m["output"]["lo"]
    assert outs.max() <= m["output"]["hi"]
    assert sum(not g for _, _, g in d) == round(m["deck"] * m["sampled_share"])
    # the lengths a slot ever holds fit the pool the harness sizes
    assert prompts.max() + outs.max() <= T.max_context(m)


def test_residual_pmf_by_hand():
    # lengths 1, 2, 2, 4: P(L >= r) = 1, 3/4, 1/4, 1/4 for r = 1..4
    pmf = T.residual_pmf([1, 2, 2, 4])
    want = np.array([1.0, 0.75, 0.25, 0.25]) / 2.25
    assert np.allclose(pmf, want)


def test_first_batch_draws_residual_lives():
    m = dict(mix("decode_heavy"))
    rows = 4000
    s = T.Stream(m, 5, 1000, rows)
    first = [s.next() for _ in range(rows)]
    pmf = T.residual_pmf([o for _, o, _ in T.deck(m)])
    want = float((np.arange(1, len(pmf) + 1) * pmf).sum())
    got = float(np.mean([r.max_new for r in first]))
    assert abs(got - want) < 0.03 * want
    assert min(r.max_new for r in first) >= 1
    # later requests take the deck's own lengths
    outs = {o for _, o, _ in T.deck(m)}
    assert all(s.next().max_new in outs for _ in range(50))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 1])
def test_first_request_is_greedy(seed):
    assert T.Stream(mix("decode_heavy"), seed, 1000, 8).next().greedy


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_every_stratum(name):
    m = mix(name)
    b = m["block"]
    d = T.deck(m)
    prompts = sorted(p for p, _, _ in d)
    outs = sorted(o for _, o, _ in d)
    per = len(d) // b

    def one_of_each(values, ranked):
        # sorted, the block's j-th value lies in stratum j's range
        return all(ranked[j * per] <= v <= ranked[(j + 1) * per - 1]
                   for j, v in enumerate(sorted(values)))

    for k in range(0, len(d), b):
        block = d[k:k + b]
        assert one_of_each([p for p, _, _ in block], prompts)
        assert one_of_each([o for _, o, _ in block], outs)
        assert sum(g for _, _, g in block) == b // 2
    # a seed's stream keeps the blocks whole
    s = T.Stream(m, 123, 1000, 0)
    firsts = [s.next() for _ in range(2 * b)]
    for k in (0, b):
        assert one_of_each([len(r.prompt) for r in firsts[k:k + b]],
                           prompts)
