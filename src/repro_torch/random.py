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
``permutation``, the LM's ``normal`` initialisers and ``categorical``
sampling) hash a 64-bit iota counter, split into (hi, lo) words, and keep
``o0 ^ o1`` of each: :func:`random_bits`.

A key is an int64 tensor whose last axis holds the two uint32 words; every
function is vectorised over the leading axes. Each public call is one
evaluation (a shaped draw one a chunk, ``randint`` three): on a CUDA key one
launch of the hand-written kernel (:mod:`repro_torch.kernels.threefry`),
which reads the key and counter operands where they lie (broadcast, views),
computes split's and the shaped draws' counters from the element's index,
and writes the key, the bits or the uniform itself; on a CPU key
:func:`threefry2x32_plain`, which emulates the uint32 arithmetic in int64
eager ops masked with ``& 0xFFFFFFFF``, then the same epilogue in eager ops.
Both give the same bits.

Shaped draws evaluate the counter in chunks of at most :data:`CHUNK`
elements of the flat index, each chunk taken from bits to its final value
and written into the output (:func:`_draw`): element ``i`` depends on
counter ``i`` alone, so the bits are those of one evaluation, and a draw's
peak memory is its output plus O(``CHUNK``) (a [16, 4096, 14336] expert
tensor's counter alone would be 940M int64 values). On the ``meta`` device
there are no values: every function returns an empty tensor of its result's
shape and dtype in one op, so an abstract ``init_params`` costs about one
op a leaf.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import threefry as kernel
from repro_torch.kernels.threefry import Count

MASK = 0xFFFFFFFF
CHUNK = 1 << 22         # counter elements a shaped draw evaluates at once
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32_plain(k0, k1, x0, x1):
    """20-round threefry2x32 of counter words (x0, x1) under key (k0, k1),
    as eager ops: each uint32 add, shift, or, xor and mask an int64 op
    (about 170 an evaluation). The arguments are int64 tensors of uint32
    values (or Python ints) that broadcast against each other; only their
    low 32 bits matter. Returns the two output words. CPU keys take it;
    CUDA keys take the kernel (:func:`_evaluate`)."""
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


def _evaluate(key: torch.Tensor, x0, x1, shape, out: str):
    """One evaluation under ``key`` [..., 2] (broadcasting to ``shape``)
    of counter words x0, x1 (tensors, ints or :class:`Count`\\ s), written
    as ``out`` says (:data:`repro_torch.kernels.threefry.OUTS`): one kernel
    launch on CUDA, the plain version on the CPU, an empty result on
    ``meta``. The only place that routes an evaluation by device."""
    shape = tuple(shape)
    k0, k1 = key[..., 0], key[..., 1]
    if key.is_cuda:
        return kernel.threefry2x32(k0, k1, x0, x1, shape, out)
    if key.is_meta:
        return torch.empty(shape + ((2,) if out == "key" else ()),
                           dtype=torch.float32 if out == "uniform"
                           else torch.int64, device="meta")
    o0, o1 = threefry2x32_plain(k0, k1, _plain_word(x0, shape, key.device),
                                _plain_word(x1, shape, key.device))
    if out == "key":
        return torch.stack([o0, o1], dim=-1)
    return _to_float(o0 ^ o1) if out == "uniform" else o0 ^ o1


def _plain_word(x, shape: tuple, device):
    """An operand of :func:`_evaluate` as the plain version takes it: an
    int64 tensor (int32 data widened, or with a 0-dim int64 key the eager
    ops would compute in int32), a Python int, or the count's words."""
    if isinstance(x, torch.Tensor):
        return x.long()
    if not isinstance(x, Count):
        return x
    count = torch.arange(x.base, x.base + shape[x.dim], dtype=torch.int64,
                         device=device).reshape(
        (-1,) + (1,) * (len(shape) - 1 - x.dim))
    return count >> 32 if x.hi else count & MASK


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, batched: key [..., 2], data int [...] (or a
    Python int). ``data`` is taken mod 2**32 as JAX's uint32 cast does. A
    Python int is passed as a constant (no tensor, no host-to-device
    copy); int32 and int64 data are read as they are."""
    if isinstance(data, int):
        return _evaluate(key, 0, data & MASK, key.shape[:-1], "key")
    data = torch.as_tensor(data, device=key.device)
    if data.dtype not in (torch.int32, torch.int64):
        data = data.long()
    # numpy's rule: torch.broadcast_shapes' first call imports torch._refs
    return _evaluate(key, 0, data,
                     np.broadcast_shapes(key.shape[:-1], data.shape), "key")


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``, batched: key [..., 2] -> [..., num, 2]."""
    shape = (*key.shape[:-1], num)
    return _evaluate(key.unsqueeze(-2), 0, Count(0, len(shape) - 1), shape,
                     "key")


def _to_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): 23 mantissa bits under
    exponent 0, minus 1.0."""
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=None, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32).

    ``shape=None``: one scalar draw per key, batched over key [..., 2] ->
    [...]. Otherwise ``key`` is one [2] key and the result has ``shape``
    (``jax.random.uniform(key, shape, minval=, maxval=)``): JAX's
    ``max(minval, floats * (maxval - minval) + minval)`` in float32, where
    XLA's CPU backend fuses the scale and shift into one multiply-add (the
    float32 product is exact in float64 and the sum is rounded once)."""
    if shape is not None:
        return _draw(key, shape, torch.float32,
                     lambda floats: _scale(floats, minval, maxval),
                     out="uniform")
    return _scale(_evaluate(key, 0, 0, key.shape[:-1], "uniform"), minval,
                  maxval)


def _scale(floats: torch.Tensor, minval: float,
           maxval: float) -> torch.Tensor:
    """``max(minval, floats * (maxval - minval) + minval)`` with the scale
    and shift fused into one rounding, as XLA's CPU backend computes it."""
    if (minval, maxval) == (0.0, 1.0):      # the range leaves floats as is
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, (floats.double() * (hi - lo).double()
                              + lo.double()).float())


# Giles' single-precision erf^-1 ("Approximating the erfinv function",
# GPU Computing Gems, 2011), the polynomial XLA evaluates for float32
# ``erf_inv``: coefficients for w = -log1p(-x^2) < 5, then for w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf^-1`` as XLA computes it (Horner steps as fused
    multiply-adds: the float32 product is exact in float64 and the sum is
    rounded once). ``torch.erfinv`` uses another algorithm and differs by up
    to ~90 ulps; this agrees with ``jax.lax.erf_inv`` on the CPU to 3 ulps
    (bit for bit on ~99% of inputs, tests/test_torch_lm.py)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.full_like(x, _ERFINV_SMALL[0])
    p = torch.where(small, p, torch.full_like(x, _ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, torch.full_like(x, a), torch.full_like(x, b))
        p = (c.double() + p.double() * t).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): JAX's ``_normal_real``,
    ``sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0), 1))``. The
    uniforms are bit-exact; :func:`erf_inv` agrees to 3 ulps. Each chunk
    goes from bits to its normal values before the next is drawn."""
    sqrt2 = np.float32(np.sqrt(2.0))
    return _draw(key, shape, torch.float32, lambda floats: erf_inv(
        _scale(floats, _NORMAL_LO, 1.0)) * sqrt2, out="uniform")


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    Gumbel-max draw ``argmax(logits + gumbel)``, ``gumbel = -log(-log(u))``
    with ``u`` uniform in ``[finfo.tiny, 1)`` of the logits' shape (JAX's
    default "low" mode). Returns int64 indices of ``logits.shape[:-1]``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    u = uniform(key.to(logits.device), logits.shape,
                float(np.finfo(np.float32).tiny), 1.0)
    return torch.argmax(logits + (-torch.log(-torch.log(u))), dim=-1)


def _bits(key: torch.Tensor, lo: int, hi: int, out: str) -> torch.Tensor:
    """``o0 ^ o1`` of ``threefry(key, (i >> 32, i & MASK))`` for the flat
    indices ``lo <= i < hi`` (``out="xor"``), or its uniform floats
    (``"uniform"``)."""
    return _evaluate(key, Count(lo, 0, hi=True), Count(lo, 0), (hi - lo,),
                     out)


def _draw(key, shape, dtype: torch.dtype, finish, keys=None,
          out: str = "xor") -> torch.Tensor:
    """A shaped draw of ``dtype`` under one [2] key, in chunks of
    :data:`CHUNK` flat indices: ``finish`` maps each chunk's bits, or its
    uniform floats for ``out="uniform"`` (one tensor per key of ``keys``,
    default ``key`` alone), to its values, which are written into the
    output. On ``meta``, the empty output."""
    shape = tuple(int(d) for d in shape)
    if key.is_meta:
        return torch.empty(shape, dtype=dtype, device="meta")
    keys = (key,) if keys is None else keys
    n = math.prod(shape)
    if n <= CHUNK:      # one chunk: no output buffer to copy into
        return finish(*(_bits(k, 0, n, out) for k in keys)).to(
            dtype).reshape(shape)
    out_buf = torch.empty(n, dtype=dtype, device=key.device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        out_buf[lo:hi] = finish(*(_bits(k, lo, hi, out) for k in keys))
    return out_buf.reshape(shape)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for one [2] key: element
    ``i`` of the flattened shape is ``o0 ^ o1`` of ``threefry(key, (i >>
    32, i & MASK))``. Returns int64 holding uint32 values."""
    return _draw(key, shape, torch.int64, lambda bits: bits)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), step by
    step as ``jax._src.random._randint``: two 32-bit draws folded into
    ``[0, span)`` as ``((hi % span) * multiplier + lo % span) % span`` with
    ``multiplier = (2**16 % span)**2 % span``. Every product and sum wraps
    at 2**32 as JAX's uint32 arithmetic does (for span > 2**16 the
    multiplier's square wraps to 0)."""
    minval, maxval = int(minval), int(maxval)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span

    def finish(hi, lo):
        offset = (((hi % span) * multiplier) & MASK) + lo % span
        return minval + (offset & MASK) % span
    k1, k2 = split(key)
    return _draw(key, shape, torch.int32, finish, keys=(k1, k2))


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
