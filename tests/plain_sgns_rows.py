"""A plain SGNS trainer with lazy row-Adam, the CPU tests' reference for the
port's ``shard_tables`` path (``torch.optim.SparseAdam``'s rule).

Self-contained: plain PyTorch and NumPy, written from the published
algorithms and the port's documented contracts, importing neither JAX,
the JAX package, the port nor the benchmark (the benchmark keeps its own
copy, ``n2vbench/reference_rows.py``). From a seed and the rounds' walks
it works out the initial tables, the pairs, the pair permutation, the
unigram^power negatives' Vose table, the negatives, the loss and the
gradients, then steps lazy Adam in ``dtype`` (float64 by default).

The RNG is threefry2x32-20 under JAX's partitionable key derivation, the
contract the port documents: ``fold_in(k, d) = threefry(k, (0, d))``,
``split(k)[i] = threefry(k, (0, i))``, shaped bits hash the 64-bit flat
index.

Lazy Adam keeps one step count t for the run. At step t it names rows:
for ``emb_in`` the distinct ids of the batch's centre column, for
``emb_out`` the distinct ids of its context and negative columns, masked
pairs and pad slots included. Only named rows update their moments and
step; every other row keeps its moments and values bit for bit. Planted
faults: ``"half_batch"`` (the batch's first half, the mean over it),
``"frozen"`` (tables left as they are), ``"dense"`` (dense Adam: every
row's moments decay and every row with moments moves).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TABLES = ("emb_in", "emb_out")
FAULTS = ("half_batch", "frozen", "dense")


# ------------------------------------------------------------ threefry --

def threefry(k0, k1, x0, x1):
    """threefry2x32 with 20 rounds on uint32 words held in int64."""
    k2 = (k0 ^ k1 ^ _PARITY) & MASK
    keys = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for group in range(5):
        for r in _ROT[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + keys[(group + 1) % 3]) & MASK
        x1 = (x1 + keys[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def key_of(seed: int) -> torch.Tensor:
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _hash(key: torch.Tensor, hi, lo) -> torch.Tensor:
    o0, o1 = threefry(key[0], key[1], torch.as_tensor(hi),
                      torch.as_tensor(lo))
    return torch.stack([o0, o1])


def fold(key: torch.Tensor, data: int) -> torch.Tensor:
    return _hash(key, 0, int(data) & MASK)


def child(key: torch.Tensor, i: int) -> torch.Tensor:
    return _hash(key, 0, i)


def flat_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits of each flat index 0..n-1 under one key."""
    i = torch.arange(n, dtype=torch.int64)
    o0, o1 = threefry(key[0], key[1], i >> 32, i & MASK)
    return o0 ^ o1


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 bits -> float32 in [0, 1) from the top 23."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


def randint_below(key: torch.Tensor, n: int, span: int) -> torch.Tensor:
    """JAX's ``randint(key, (n,), 0, span)``."""
    m = (2 ** 16) % span
    m = ((m * m) & MASK) % span
    a = flat_bits(child(key, 0), n)
    b = flat_bits(child(key, 1), n)
    return (((((a % span) * m) & MASK) + b % span) & MASK) % span


def shuffle(key: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``permutation(key, n)``: rounds of a stable sort by fresh
    bits of the running key's second child."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        key, sub = child(key, 0), child(key, 1)
        x = x[torch.sort(flat_bits(sub, n), stable=True).indices]
    return x


# ------------------------------------------------------------- tables --

def vose(w: np.ndarray):
    """Vose's alias table (float64 arithmetic, stacks popped from the
    back) -> (prob float32, alias int64)."""
    k = len(w)
    scaled = (np.asarray(w, np.float64) * (k / float(np.sum(w)))).tolist()
    small = [i for i, s in enumerate(scaled) if s < 1.0]
    large = [i for i, s in enumerate(scaled) if s >= 1.0]
    p, a = [1.0] * k, list(range(k))
    while small and large:
        s, g = small.pop(), large.pop()
        p[s], a[s] = scaled[s], g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    return (torch.tensor(np.asarray(p, np.float32)),
            torch.tensor(a, dtype=torch.int64))


def init_tables(seed: int, vocab: int, dim: int):
    """emb_in = (u - 0.5) * 2 / sqrt(dim) over the first child's
    uniforms; emb_out = 0."""
    u = unit_float(flat_bits(child(key_of(seed), 0), vocab * dim))
    scale = 1.0 / torch.sqrt(torch.tensor(float(dim)))
    emb_in = ((u - 0.5) * 2 * scale).reshape(vocab, dim)
    return emb_in, torch.zeros_like(emb_in)


def pairs(walk: torch.Tensor, window: int):
    """(centre, context, valid) by offset: forward then backward pairs;
    a vertex with itself is not valid."""
    length = walk.shape[1]
    cs, xs = [], []
    for off in range(1, min(window, length - 1) + 1):
        a = walk[:, :length - off].reshape(-1)
        b = walk[:, off:].reshape(-1)
        cs += [a, b]
        xs += [b, a]
    c, x = torch.cat(cs), torch.cat(xs)
    return c, x, c != x


def negatives(key, prob, alias, b: int, k: int) -> torch.Tensor:
    slots = randint_below(child(key, 0), b * k, prob.shape[0])
    u = unit_float(flat_bits(child(key, 1), b * k))
    return torch.where(u >= prob[slots], alias[slots], slots).reshape(b, k)


# ---------------------------------------------------------- training --

def train(rounds, vocab: int, dim: int, window: int, negs: int,
          batch: int, lr: float, seed: int, power: float = 0.75,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          dtype=torch.float64, fault: str | None = None) -> dict:
    """Lazy row-Adam SGNS over whole rounds of walks (each [W, L]), one
    epoch a round, as one trainer seeded ``seed``. Returns each step's
    loss, the final ``tables`` and, by table, the rows some step named
    (``named``, a [V] mask)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    emb_in, emb_out = init_tables(seed, vocab, dim)
    params = {"emb_in": emb_in.to(dtype), "emb_out": emb_out.to(dtype)}
    mu = {n: torch.zeros_like(t) for n, t in params.items()}
    nu = {n: torch.zeros_like(t) for n, t in params.items()}
    named = {n: torch.zeros(vocab, dtype=torch.bool) for n in TABLES}
    counts = np.zeros(vocab, np.float64)
    lane = torch.arange(batch)
    losses, t = [], 0
    for r, walk in enumerate(rounds):
        walk = torch.as_tensor(np.asarray(walk), dtype=torch.int64)
        counts += np.bincount(walk.reshape(-1).numpy(), minlength=vocab)
        freq = counts ** power
        prob, alias = vose(freq if freq.sum() else np.ones(vocab))
        c, x, valid = pairs(walk, window)
        n_pairs = c.shape[0]
        rkey = fold(fold(key_of(seed), r), 0)            # epoch 0
        perm = shuffle(child(rkey, 0), n_pairs)
        skey = child(rkey, 1)
        for s in range(-(-n_pairs // batch)):
            idx = perm[s * batch:(s + 1) * batch]
            idx = torch.cat([idx, idx.new_zeros(batch - idx.shape[0])])
            center, pos = c[idx], x[idx]
            neg = negatives(fold(skey, s), prob, alias, batch, negs)
            keep = (valid[idx] & ((s * batch + lane) < n_pairs)).to(dtype)
            if fault == "half_batch":
                keep = keep * (lane < batch // 2).to(dtype)
            ci = params["emb_in"][center]
            po = params["emb_out"][pos]
            no = params["emb_out"][neg]
            xp = (ci * po).sum(-1)
            xn = (no * ci[:, None, :]).sum(-1)
            per = torch.nn.functional.softplus(-xp) + \
                torch.nn.functional.softplus(xn).sum(-1)
            denom = torch.clamp(keep.sum(), min=1.0)
            losses.append(float((per * keep).sum() / denom))
            cp = ((torch.sigmoid(xp) - 1.0) * keep / denom)[:, None]
            cn = (torch.sigmoid(xn) * keep[:, None] / denom)[:, :, None]
            grads = {
                "emb_in": torch.zeros_like(params["emb_in"]).index_add_(
                    0, center, cp * po + (cn * no).sum(1)),
                "emb_out": torch.zeros_like(params["emb_out"])
                .index_add_(0, pos, cp * ci)
                .index_add_(0, neg.reshape(-1),
                            (cn * ci[:, None, :]).reshape(-1, dim))}
            t += 1
            rows = {"emb_in": torch.unique(center),
                    "emb_out": torch.unique(torch.cat([pos,
                                                       neg.reshape(-1)]))}
            for n, at in rows.items():
                named[n][at] = True
                if fault == "dense":
                    at = slice(None)
                g = grads[n][at]
                m = mu[n][at] * b1 + g * (1 - b1)
                v = nu[n][at] * b2 + g * g * (1 - b2)
                mu[n][at], nu[n][at] = m, v
                if fault != "frozen":
                    den = (v / (1 - b2 ** t)).sqrt() + eps
                    params[n][at] += m / den * (-lr / (1 - b1 ** t))
    return {"losses": losses, "tables": params, "named": named}
