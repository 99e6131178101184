"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same numpy inputs, float32 on the
CPU.

The routing must agree exactly (``topi`` equal, ties included: one swapped
tie changes which later token a full expert drops); the outputs within
1e-5 (the two frameworks sum the expert products in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import MoEConfig as JaxMoE  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.config import MoEConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5
D, DE = 8, 16


def configs(**kw):
    base = dict(num_experts=4, experts_per_token=2, d_expert=DE,
                capacity_factor=2.0)
    base.update(kw)
    return JaxMoE(**base), MoEConfig(**base)


def weights(seed, e, d=D, de=DE):
    rng = np.random.RandomState(seed)
    return {"router": (0.5 * rng.randn(d, e)).astype(np.float32),
            "wg": (0.2 * rng.randn(e, d, de)).astype(np.float32),
            "wu": (0.2 * rng.randn(e, d, de)).astype(np.float32),
            "wd": (0.2 * rng.randn(e, de, d)).astype(np.float32)}


def both(w):
    return ({k: jnp.asarray(a) for k, a in w.items()},
            {k: torch.from_numpy(a) for k, a in w.items()})


def drops(topi, moe):
    """Dropped (token, choice) pairs of a call, counted on the host."""
    flat = np.asarray(topi).reshape(-1)
    seen = np.zeros(moe.num_experts, int)
    n = 0
    for e in flat:
        n += seen[e] >= jmoe.expert_capacity(len(topi), moe)
        seen[e] += 1
    return n


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cf,experts,k,normalize", [
    (4.0, 4, 2, True),          # generous: nothing dropped
    (0.5, 4, 2, False),         # tight: full experts drop slots
    (1.25, 16, 2, False),       # phi3.5-moe's routing shape
    (1.25, 8, 4, True),         # qwen3-moe's renormalised top-k
])
def test_moe_ffn_matches_jax(seed, cf, experts, k, normalize):
    jm, tm = configs(num_experts=experts, experts_per_token=k,
                     capacity_factor=cf, normalize_router_weights=normalize)
    jw, tw = both(weights(seed, experts))
    x = np.random.RandomState(100 + seed).randn(48, D).astype(np.float32)
    jv, ji, jp = jmoe.router_probs(jnp.asarray(x), jw["router"], jm)
    tv, ti, tp = tmoe.router_probs(torch.from_numpy(x), tw["router"], tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=TOL, atol=TOL)
    want = jmoe.moe_ffn(jnp.asarray(x), jw, jm)
    got = tmoe.moe_ffn(torch.from_numpy(x), tw, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    n_drop = drops(ji, jm)
    if cf == 4.0:
        assert n_drop == 0
    if cf == 0.5:
        assert n_drop > 0
    # the port's slot numbering drops exactly the reference's pairs
    _, jpos = jmoe._positions_in_expert(ji, experts)
    _, tpos = tmoe._positions_in_expert(ti, experts)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("normalize", [True, False])
def test_exact_ties_take_the_lower_expert_first(normalize):
    """Zero input rows give equal logits for every expert, and a router
    with two equal columns ties those two experts on every row: top-k puts
    the lower id first, as ``jax.lax.top_k`` does, and at a tight capacity
    the same later tokens are dropped."""
    jm, tm = configs(capacity_factor=0.5, normalize_router_weights=normalize)
    w = weights(3, 4)
    w["router"][:, 3] = w["router"][:, 1]
    jw, tw = both(w)
    x = np.random.RandomState(4).randn(24, D).astype(np.float32)
    x[::3] = 0.0                              # every third row ties all
    _, ji, _ = jmoe.router_probs(jnp.asarray(x), jw["router"], jm)
    _, ti, _ = tmoe.router_probs(torch.from_numpy(x), tw["router"], tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [0, 1]
    for row in ti.tolist():                   # 1 always wins its tie with 3
        assert 3 not in row or row.index(1) < row.index(3)
    assert drops(ji, jm) > 0
    want = jmoe.moe_ffn(jnp.asarray(x), jw, jm)
    got = tmoe.moe_ffn(torch.from_numpy(x), tw, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_router_normalisation_both_ways(normalize):
    """Renormalised top-k weights sum to 1; raw ones to the top-k softmax
    mass, below 1.  Both as the JAX package's."""
    jm, tm = configs(normalize_router_weights=normalize)
    jw, tw = both(weights(5, 4))
    x = np.random.RandomState(6).randn(16, D).astype(np.float32)
    jv, _, _ = jmoe.router_probs(jnp.asarray(x), jw["router"], jm)
    tv, _, _ = tmoe.router_probs(torch.from_numpy(x), tw["router"], tm)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    sums = tv.sum(-1)
    if normalize:
        torch.testing.assert_close(sums, torch.ones(16), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert (sums < 1).all()


@pytest.mark.parametrize("chunk", [8, 16])
def test_token_chunk_equals_unchunked_and_jax(chunk):
    """Chunks of the tokens, each with its own capacity: at a generous
    capacity nothing drops, so chunked equals unchunked; and the chunked
    call equals the JAX package's scan over the same chunks."""
    jm, tm = configs(capacity_factor=4.0)
    jw, tw = both(weights(7, 4))
    x = np.random.RandomState(8).randn(32, D).astype(np.float32)
    full = tmoe.moe_ffn(torch.from_numpy(x), tw, tm)
    got = tmoe.moe_ffn(torch.from_numpy(x), tw, tm, token_chunk=chunk)
    torch.testing.assert_close(got, full, rtol=TOL, atol=TOL)
    want = jmoe.moe_ffn(jnp.asarray(x), jw, jm, token_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_expert_shard_partial_sums_equal_full(cf):
    """Two half-expert slices' partial outputs sum to the full output,
    capacity drops included, and each equals the JAX package's."""
    jm, tm = configs(capacity_factor=cf)
    w = weights(9, 4)
    jw, tw = both(w)
    x = np.random.RandomState(10).randn(16, D).astype(np.float32)
    full = tmoe.moe_ffn(torch.from_numpy(x), tw, tm)
    parts = []
    for e0, ec in [(0, 2), (2, 2)]:
        ws = {"router": w["router"], **{k: w[k][e0:e0 + ec]
                                       for k in ("wg", "wu", "wd")}}
        jws, tws = both(ws)
        part = tmoe.moe_ffn(torch.from_numpy(x), tws, tm,
                            expert_shard=(e0, ec))
        want = jmoe.moe_ffn(jnp.asarray(x), jws, jm, expert_shard=(e0, ec))
        np.testing.assert_allclose(part.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        parts.append(part)
    torch.testing.assert_close(parts[0] + parts[1], full, rtol=TOL, atol=TOL)


def test_expert_capacity_matches_jax():
    for e, k, cf in [(4, 2, 2.0), (16, 2, 1.25), (128, 8, 1.25), (8, 1, 0.5)]:
        jm, tm = configs(num_experts=e, experts_per_token=k,
                         capacity_factor=cf)
        for n in (1, 2, 7, 20, 32, 333, 4096):
            assert tmoe.expert_capacity(n, tm) == \
                jmoe.expert_capacity(n, jm), (e, k, cf, n)
    _, tm = configs()
    assert tmoe.expert_capacity(1, tm) == 4            # the floor


@pytest.mark.parametrize("seed", [0, 1])
def test_load_balance_loss_matches_jax(seed):
    jm, tm = configs()
    jw, tw = both(weights(11 + seed, 4))
    x = np.random.RandomState(seed).randn(64, D).astype(np.float32)
    _, ji, jp = jmoe.router_probs(jnp.asarray(x), jw["router"], jm)
    _, ti, tp = tmoe.router_probs(torch.from_numpy(x), tw["router"], tm)
    want = jmoe.moe_load_balance_loss(jp, ji, jm)
    got = tmoe.moe_load_balance_loss(tp, ti, tm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # uniform routing and probabilities give exactly 1
    probs = torch.full((8, 4), 0.25)
    topi = torch.tensor([[0, 1], [2, 3]] * 4)
    assert float(tmoe.moe_load_balance_loss(probs, topi, tm)) == 1.0


def test_reference_padding_rows_take_expert_capacity():
    """A defect of the reference that the port keeps for parity: the MoE
    FFN routes every row of a call, so padding rows (the pad positions of
    a prefill chunk, a decode tick's free slots: one token, one route)
    take expert slots in token-major order, and a real token after them
    can be dropped that would be kept without them.  Eight identical pad
    rows before eight real ones at the real configs' capacity factor:
    both packages change the real rows' outputs alike."""
    jm, tm = configs(capacity_factor=1.25)
    jw, tw = both(weights(13, 4))
    rng = np.random.RandomState(14)
    real = rng.randn(8, D).astype(np.float32)
    x = np.concatenate([np.repeat(rng.randn(1, D), 8, 0).astype(np.float32),
                        real])
    alone = tmoe.moe_ffn(torch.from_numpy(real), tw, tm)
    padded = tmoe.moe_ffn(torch.from_numpy(x), tw, tm)[8:]
    want = jmoe.moe_ffn(jnp.asarray(x), jw, jm)[8:]
    np.testing.assert_allclose(padded.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    changed = (padded - alone).abs().amax(-1) > 1e-4
    assert changed.any()
    _, ti, _ = tmoe.router_probs(torch.from_numpy(x), tw["router"], tm)
    assert drops(ti.numpy(), jm) > 0
