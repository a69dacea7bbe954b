"""Port's threefry2x32 against jax.random, bit for bit (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.walk import walker_key as jax_walker_key
from repro_torch import random as jr
from repro_torch.convert import key_from_numpy
from repro_torch.core.walk import step_uniforms, walker_key

SEEDS = [0, 1, 11, 5, 7000024, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 33 + 5, -3]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split_uniform(seed):
    jk = jax.random.PRNGKey(seed)
    tk = jr.PRNGKey(seed)
    assert np.array_equal(tk.numpy(), _np(jk))
    data = np.array([0, 1, 7, 255, 65536, 2 ** 31 - 1], np.int64)
    want = np.stack([_np(jax.random.fold_in(jk, int(d))) for d in data])
    assert np.array_equal(jr.fold_in(tk, torch.from_numpy(data)).numpy(),
                          want)
    assert np.array_equal(jr.split(tk).numpy(), _np(jax.random.split(jk)))
    assert np.array_equal(jr.split(tk, 3).numpy(),
                          _np(jax.random.split(jk, 3)))
    assert jr.uniform(tk).numpy() == np.asarray(jax.random.uniform(jk))


def test_uniform_bits_over_many_keys():
    """uniform's float construction (bits >> 9 | 0x3F800000, minus 1)
    over 4,096 keys, batched against a vmapped jax.random.uniform."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (4096, 2), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(jax.vmap(jax.random.uniform)(jnp.asarray(keys)))
    got = jr.uniform(torch.from_numpy(keys.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 1000003])
def test_walker_keys_and_step_uniforms(seed):
    """Per-(walker, step) keys and the exact draw's uniforms over a sweep
    of walker ids and steps, as core/walk.py and engine/sampler.py make
    them in the JAX package."""
    ids = np.array([0, 1, 2, 17, 255, 4095, 2 ** 31 - 1], np.int32)
    steps = np.arange(0, 9, dtype=np.int32)
    jk = jax.random.PRNGKey(seed)
    want = np.asarray(jax.vmap(lambda i: jax.vmap(
        lambda s: jax_walker_key(jk, i, s))(steps))(jnp.asarray(ids)))
    tk = jr.PRNGKey(seed)
    got = walker_key(tk, torch.from_numpy(ids).long()[:, None],
                     torch.from_numpy(steps).long()[None, :])
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    want_u = np.asarray(jax.vmap(lambda i: jax.vmap(
        lambda s: jax.random.uniform(jax.random.split(
            jax_walker_key(jk, i, s))[0]))(steps[1:]))(jnp.asarray(ids)))
    got_u = step_uniforms(tk, torch.from_numpy(ids).long(), len(steps))
    assert np.array_equal(got_u.numpy(), want_u)


def test_key_from_numpy():
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 123)
    tk = key_from_numpy(np.asarray(jk))
    assert np.array_equal(tk.numpy(), _np(jk))
    assert jr.uniform(tk).numpy() == np.asarray(jax.random.uniform(jk))
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(3, np.uint32))


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 5])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (64, 33)])
def test_random_bits_and_shaped_uniform(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    bits = jr.random_bits(tk, shape)
    assert bits.shape == shape
    assert np.array_equal(bits.numpy(), np.asarray(
        jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    u = jr.uniform(tk, shape)
    assert u.dtype == torch.float32
    assert np.array_equal(u.numpy(), np.asarray(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("span", [1, 60, 400, 65_536, 65_537, 131_071,
                                  2 ** 17])
@pytest.mark.parametrize("seed", [0, 7])
def test_randint(span, seed):
    """Spans that are not powers of two are where the uint32 wraparound
    of the multiplier and the products matters."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tk = jr.fold_in(jr.PRNGKey(seed), 5)
    for lo, shape in ((0, (256, 5)), (3, (9,)), (-40, (2, 3, 4))):
        want = np.asarray(jax.random.randint(jk, shape, lo, lo + span))
        got = jr.randint(tk, shape, lo, lo + span)
        assert got.dtype == torch.int32 and got.shape == shape
        assert np.array_equal(got.numpy(), want)
    # maxval <= minval gives minval, as in JAX
    assert np.array_equal(jr.randint(tk, (4,), 5, 5).numpy(),
                          np.asarray(jax.random.randint(jk, (4,), 5, 5)))


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 70_000])
def test_permutation(n):
    """70,000 elements take 2 stable sort rounds (ceil(3 ln n / ln(2^32
    - 1))); fewer than ~1,600 take 1, and 0 or 1 element take none."""
    for seed in (0, 3):
        jk = jax.random.PRNGKey(seed)
        got = jr.permutation(jr.PRNGKey(seed), n)
        assert np.array_equal(got.numpy(),
                              np.asarray(jax.random.permutation(jk, n)))
    assert np.array_equal(np.sort(got.numpy()), np.arange(n))


@pytest.mark.parametrize("chunk", [7, 64, 1000])
@pytest.mark.parametrize("shape", [(7,), (9, 13), (2, 64, 8), (1000,)])
def test_chunked_draws_equal_one_chunk_and_jax(monkeypatch, chunk, shape):
    """Shaped draws evaluated in chunks of ``chunk`` flat indices (a small
    test-only chunk, so sizes straddle chunk edges): ``random_bits``,
    ``uniform``, ``normal`` and ``randint`` are ``torch.equal`` to one
    chunk, and the integer and uniform draws equal ``jax.random``."""
    jk, tk = jax.random.PRNGKey(5), jr.PRNGKey(5)

    def draws():
        return (jr.random_bits(tk, shape), jr.uniform(tk, shape, -2.0, 3.5),
                jr.normal(tk, shape), jr.randint(tk, shape, -3, 70_001))
    whole = draws()
    monkeypatch.setattr(jr, "CHUNK", chunk)
    for a, b in zip(draws(), whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    bits, uni, _, ints = draws()
    assert np.array_equal(bits.numpy(), np.asarray(
        jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    assert np.array_equal(uni.numpy(), np.asarray(
        jax.random.uniform(jk, shape, minval=-2.0, maxval=3.5)))
    assert np.array_equal(ints.numpy(), np.asarray(
        jax.random.randint(jk, shape, -3, 70_001)))


def test_meta_draws_return_their_shape_without_computing():
    """On ``meta`` a draw is an empty tensor of its shape and dtype: no
    threefry rounds run (one evaluation is ~140 ops), whatever the size;
    ``randint``'s key split adds a few ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))
    key = jr.PRNGKey(0, device="meta")
    shape = (16, 4096, 14336)
    for draw, dtype in ((lambda: jr.normal(key, shape), torch.float32),
                        (lambda: jr.uniform(key, shape), torch.float32),
                        (lambda: jr.random_bits(key, shape), torch.int64),
                        (lambda: jr.randint(key, shape, 0, 9), torch.int32)):
        with Ops() as seen:
            out = draw()
        assert out.is_meta and out.shape == shape and out.dtype == dtype
        assert len(seen.ops) < 12, seen.ops
    with Ops() as seen:
        sub = jr.split(jr.fold_in(key, 3), 4)
    assert sub.shape == (4, 2) and sub.is_meta and len(seen.ops) < 20
