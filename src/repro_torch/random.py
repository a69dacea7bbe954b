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

A key is an int64 tensor whose last axis holds the two uint32 words; every
function is vectorised over the leading axes. uint32 arithmetic is emulated
in int64 and masked with ``& 0xFFFFFFFF``.
"""
from __future__ import annotations

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
    Python int). ``data`` is taken mod 2**32 as JAX's uint32 cast does."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    return _counter(key, torch.zeros_like(data), data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``, batched: key [..., 2] -> [..., num, 2]."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return _counter(key.unsqueeze(-2), torch.zeros_like(idx), idx)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` (scalar float32 draw), batched over
    key [..., 2] -> [...] float32: 23 random mantissa bits under exponent
    0, minus 1.0."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    out = _counter(key, zero, zero)
    fbits = (((out[..., 0] ^ out[..., 1]) >> 9) | 0x3F800000)
    return fbits.to(torch.int32).view(torch.float32) - 1.0
