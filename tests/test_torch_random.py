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
