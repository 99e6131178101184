"""The port's sampler against ``repro.serving.sampler`` on the same noise.

The port takes its Gumbel noise as an argument; the JAX sampler draws it
inside ``jax.random.categorical``.  Here, within each test only,
``jax.random.categorical`` is replaced by ``argmax(logits + noise[key[0]])``
and row ``i`` gets the key ``[i, 0]``, so both samplers see the same numpy
noise.  Tokens must match exactly (same float32 arithmetic on the same
inputs); log-probabilities within 1e-6 (log-softmax is summed in another
order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampler as jax_sampler  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, V = 6, 256


@pytest.fixture
def draw(monkeypatch):
    """Swap in a categorical draw that reads the noise handed to ``both``;
    returns the default noise table."""
    box = {}

    def categorical(key, logits, axis=-1):
        return jnp.argmax(logits + box["noise"][key[0]], axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    rng = np.random.RandomState(7)
    noise = -np.log(-np.log(rng.uniform(1e-9, 1.0, (B, V)))).astype(np.float32)
    return box, noise


def both(box, logits, noise, temp, top_k, top_p):
    box["noise"] = jnp.asarray(noise)
    keys = np.stack([np.arange(B), np.zeros(B)], 1).astype(np.uint32)
    want = np.asarray(jax_sampler.sample_batched(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p)))
    got = sampler.sample_batched(
        torch.from_numpy(logits), torch.from_numpy(noise),
        torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p)).numpy()
    return got, want


def rows(temp, top_k, top_p):
    return (np.asarray(temp, np.float32), np.asarray(top_k, np.int32),
            np.asarray(top_p, np.float32))


def logits_with_ties(seed=0):
    rng = np.random.RandomState(seed)
    x = (3 * rng.randn(B, V)).astype(np.float32)
    # ties at the top-k cutoff: the 3rd..6th largest of every row equal
    order = np.argsort(-x, axis=1)
    for r in range(B):
        x[r, order[r, 2:6]] = x[r, order[r, 2]]
    return x


CASES = {
    "greedy": rows([0] * B, [0] * B, [1] * B),
    "temperature": rows([0.7] * B, [0] * B, [1] * B),
    "top_k_ties": rows([1.0] * B, [3, 4, 5, 3, 1, 6], [1] * B),
    "top_p": rows([0.9] * B, [0] * B, [0.5, 0.9, 0.95, 0.3, 0.99, 0.7]),
    "mixed": rows([0, 0.8, 1.0, 0, 0.9, 1.3], [0, 0, 20, 5, 0, 3],
                  [1, 0.95, 1, 1, 0.92, 0.8]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_batched_matches_jax(case, draw):
    box, noise = draw
    logits = logits_with_ties()
    got, want = both(box, logits, noise, *CASES[case])
    np.testing.assert_array_equal(got, want)
    greedy = CASES[case][0] <= 0
    np.testing.assert_array_equal(got[greedy], logits.argmax(-1)[greedy])


def test_top_k_keeps_ties_at_the_cutoff(draw):
    """With k=3 and the 3rd..6th values tied, all four stay eligible: a
    large noise on any of them must be able to win."""
    logits = logits_with_ties(1)
    tied = np.argsort(-logits, axis=1)[:, 5]           # a tied 6th value
    box, noise = draw
    noise = np.zeros_like(noise)
    noise[np.arange(B), tied] = 100.0
    got, want = both(box, logits, noise, *rows([1.0] * B, [3] * B, [1] * B))
    np.testing.assert_array_equal(got, tied)
    np.testing.assert_array_equal(want, tied)


def test_token_logprobs_match_jax():
    logits = logits_with_ties(2)
    toks = np.random.RandomState(3).randint(0, V, B).astype(np.int32)
    want = np.asarray(jax_sampler.token_logprobs(jnp.asarray(logits),
                                                 jnp.asarray(toks)))
    got = sampler.token_logprobs(torch.from_numpy(logits),
                                 torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_noise_depends_on_seed_request_and_token_only():
    gen = torch.Generator()
    base = [sampler.request_seed(0, rid) for rid in (5, 9)]
    a = sampler.RowSampling(keys=np.asarray(base, np.int64),
                            steps=np.asarray([3, 0], np.int32),
                            temp=np.asarray([1.0, 0.5], np.float32),
                            top_k=np.zeros(2, np.int32),
                            top_p=np.ones(2, np.float32))
    # the same rows in the other order, beside a greedy row
    b = sampler.RowSampling(keys=np.asarray([base[1], 0, base[0]], np.int64),
                            steps=np.asarray([0, 0, 3], np.int32),
                            temp=np.asarray([0.5, 0.0, 1.0], np.float32),
                            top_k=np.zeros(3, np.int32),
                            top_p=np.ones(3, np.float32))
    na = sampler.gumbel_noise(a, V, "cpu", gen)
    nb = sampler.gumbel_noise(b, V, "cpu", gen)
    np.testing.assert_array_equal(na[0].numpy(), nb[2].numpy())
    np.testing.assert_array_equal(na[1].numpy(), nb[0].numpy())
    assert (nb[1] == 0).all()
    assert not torch.equal(na[0], na[1])
    assert sampler.request_seed(0, 5) != sampler.request_seed(1, 5)
