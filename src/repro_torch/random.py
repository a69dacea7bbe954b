"""threefry2x32 counter-based PRNG, bit-exact with ``jax.random``.

The walk's RNG contract (``core.walk.walker_key``) is a pure function of
(seed, walker, step), so the port reproduces JAX's bits exactly and walks
can be compared integer for integer against the JAX package.

This follows JAX with ``jax_threefry_partitionable=True`` (the default of
the JAX releases this repository runs), under which every call the walk
path makes reduces to one threefry2x32 evaluation on a 64-bit counter
split into (hi, lo) words:

    PRNGKey(seed)      = (0, seed mod 2**32)            (32-bit seeds)
    fold_in(key, d)    = threefry(key, (0, d))
    split(key)[i]      = threefry(key, (0, i))
    uniform(key)       = f32((o0 ^ o1) >> 9 | 0x3F800000) - 1.0,
                         with (o0, o1) = threefry(key, (0, 0))

Shaped draws (the SGNS stage's ``randint``, ``uniform`` and
``permutation``) hash a 64-bit iota counter, split into (hi, lo) words, and
keep ``o0 ^ o1`` of each: :func:`random_bits`.

A key is an int64 tensor whose last axis holds the two uint32 words; every
function is vectorised over the leading axes. uint32 arithmetic is emulated
in int64 and masked with ``& 0xFFFFFFFF``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """20-round threefry2x32 of counter words (x0, x1) under key (k0, k1).

    All four arguments are int64 tensors of uint32 values that broadcast
    against each other; returns the two output words.
    """
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python int seed: [2] int64.

    JAX (without 64-bit mode) keeps the low 32 bits of the seed and a zero
    high word."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _counter(key: torch.Tensor, hi, lo) -> torch.Tensor:
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([o0, o1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, batched: key [..., 2], data int [...] (or a
    Python int). ``data`` is taken mod 2**32 as JAX's uint32 cast does. A
    Python int is filled in on the key's device (no host-to-device copy)."""
    if isinstance(data, int):
        data = torch.full((), data & MASK, dtype=torch.int64,
                          device=key.device)
    else:
        data = torch.as_tensor(data, dtype=torch.int64,
                               device=key.device) & MASK
    return _counter(key, torch.zeros_like(data), data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``, batched: key [..., 2] -> [..., num, 2]."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return _counter(key.unsqueeze(-2), torch.zeros_like(idx), idx)


def _to_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): 23 mantissa bits under
    exponent 0, minus 1.0."""
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=None) -> torch.Tensor:
    """``jax.random.uniform``.

    ``shape=None``: one scalar draw per key, batched over key [..., 2] ->
    [...] float32. Otherwise ``key`` is one [2] key and the result has
    ``shape`` (``jax.random.uniform(key, shape)``)."""
    if shape is not None:
        return _to_float(random_bits(key, shape))
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    out = _counter(key, zero, zero)
    return _to_float(out[..., 0] ^ out[..., 1])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for one [2] key: element
    ``i`` of the flattened shape is ``o0 ^ o1`` of ``threefry(key, (i >>
    32, i & MASK))``. Returns int64 holding uint32 values."""
    shape = tuple(int(d) for d in shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=key.device)
    o0, o1 = threefry2x32(key[0], key[1], count >> 32, count & MASK)
    return (o0 ^ o1).reshape(shape)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), step by
    step as ``jax._src.random._randint``: two 32-bit draws folded into
    ``[0, span)`` as ``((hi % span) * multiplier + lo % span) % span`` with
    ``multiplier = (2**16 % span)**2 % span``. Every product and sum wraps
    at 2**32 as JAX's uint32 arithmetic does (for span > 2**16 the
    multiplier's square wraps to 0)."""
    minval, maxval = int(minval), int(maxval)
    k1, k2 = split(key)
    hi = random_bits(k1, shape)
    lo = random_bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = (((hi % span) * multiplier) & MASK) + lo % span
    offset = (offset & MASK) % span
    return (minval + offset).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64): JAX's ``_shuffle``, i.e.
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a stable sort of the
    current order by 32 fresh random bits under ``split(key)[1]``."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
