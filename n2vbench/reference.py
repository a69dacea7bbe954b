"""The plain reference the benchmark judges the port by.

Plain PyTorch and NumPy, written from the published algorithms and the
port's documented contracts alone: it imports nothing of the program and
takes nothing the program made. From the CSR graph and the run's seeds it
works out again what the program's set-up and timed path derive: the
first-order alias tables, every walker's keys and uniforms, the
second-order (p, q) draw of every superstep, and for SGNS the initial
tables, the unigram^power negative table, the pairs, the pair permutation,
the negatives, the loss, the gradients and dense Adam.

The RNG is threefry2x32-20 (Salmon et al., SC'11) under JAX's
partitionable key derivation, the contract the port documents
(``fold_in(k, d) = threefry(k, (0, d))``, ``split(k)[i] = threefry(k, (0,
i))``, shaped bits hash the 64-bit flat index). The second-order draw's
prefix sum is the blocked base-16 order the port's contract fixes, so a
float32 reference gives the program's walks integer for integer.

Every function takes a ``dtype``: float32 (float64 for SGNS) is the
reference, bfloat16 the control of the precision below it.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
PAD = int(np.iinfo(np.int32).max)
SCAN_BASE = 16
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ------------------------------------------------------------ threefry --

def threefry(k0, k1, x0, x1):
    """threefry2x32 with 20 rounds; uint32 words held in int64 tensors that
    broadcast together. Returns the two output words."""
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


def key_of(seed, device) -> torch.Tensor:
    """Keys [..., 2] of integer seeds: (0, seed mod 2**32)."""
    s = torch.as_tensor(np.asarray(seed, dtype=np.int64) & MASK,
                        device=device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def hash_key(key: torch.Tensor, hi, lo) -> torch.Tensor:
    o0, o1 = threefry(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([o0, o1], dim=-1)


def fold(key: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    return hash_key(key, torch.zeros_like(d), d)


def child(key: torch.Tensor, i: int) -> torch.Tensor:
    """The ``i``-th key of splitting ``key``."""
    z = torch.zeros(key.shape[:-1], dtype=torch.int64, device=key.device)
    return hash_key(key, z, z + i)


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1) from the top 23 bits."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


def scalar_uniform(key: torch.Tensor) -> torch.Tensor:
    z = torch.zeros(key.shape[:-1], dtype=torch.int64, device=key.device)
    o = hash_key(key, z, z)
    return unit_float(o[..., 0] ^ o[..., 1])


def flat_bits(key: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Bits of the flat indices ``lo <= i < hi`` under one [2] key."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
    o0, o1 = threefry(key[0], key[1], i >> 32, i & MASK)
    return o0 ^ o1


def shaped(key: torch.Tensor, n: int, finish, dtype, chunk: int = 1 << 23
           ) -> torch.Tensor:
    """``finish`` of the bits of flat indices ``0..n-1``, chunk by chunk."""
    out = torch.empty(n, dtype=dtype, device=key.device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        out[lo:hi] = finish(flat_bits(key, lo, hi))
    return out


def randint_below(key: torch.Tensor, n: int, span: int) -> torch.Tensor:
    """JAX's ``randint(key, (n,), 0, span)``: two 32-bit draws under the
    key's two children, ``((hi % span) * m + lo % span) % span`` with
    ``m = (2**16 % span)**2 % span``, every step wrapping at 2**32."""
    m = (2 ** 16) % span
    m = ((m * m) & MASK) % span
    k_hi, k_lo = child(key, 0), child(key, 1)
    out = torch.empty(n, dtype=torch.int64, device=key.device)
    step = 1 << 23
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        a = flat_bits(k_hi, lo, hi)
        b = flat_bits(k_lo, lo, hi)
        off = (((a % span) * m) & MASK) + b % span
        out[lo:hi] = (off & MASK) % span
    return out


def shuffle(key: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``permutation(key, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds, each a stable sort of the order by fresh bits of the second
    child of the running key."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = child(key, 0), child(key, 1)
        bits = shaped(sub, n, lambda b: b, torch.int64)
        x = x[torch.sort(bits, stable=True).indices]
    return x


# ----------------------------------------------------------- Vose alias --

def vose(w: np.ndarray):
    """Vose's alias table of one weight vector (float64 arithmetic, the
    stacks popped from the back) -> (prob float32, alias int32)."""
    k = len(w)
    prob = np.ones(k, dtype=np.float32)
    alias = np.arange(k, dtype=np.int32)
    total = float(np.asarray(w, np.float64).sum())
    if k == 0 or total <= 0:
        return prob, alias
    scaled = (np.asarray(w, np.float64) * (k / total)).tolist()
    small = [i for i, s in enumerate(scaled) if s < 1.0]
    large = [i for i, s in enumerate(scaled) if s >= 1.0]
    p = [1.0] * k
    a = list(range(k))
    while small and large:
        s = small.pop()
        g = large.pop()
        p[s] = scaled[s]
        a[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        if scaled[g] < 1.0:
            small.append(g)
        else:
            large.append(g)
    prob[:] = p
    alias[:] = a
    return prob, alias


# ---------------------------------------------------------------- walks --

def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the last axis in base-16 blocks: left to
    right inside each block, the block totals by the same rule, then each
    block's exclusive carry added. Exact in ``x``'s dtype."""
    d = x.shape[-1]
    if d <= SCAN_BASE:
        out = x.clone()
        for j in range(1, d):
            out[..., j] = out[..., j - 1] + x[..., j]
        return out
    nb = -(-d // SCAN_BASE)
    pad = torch.zeros(*x.shape[:-1], nb * SCAN_BASE - d, dtype=x.dtype,
                      device=x.device)
    blocks = torch.cat([x, pad], -1).reshape(*x.shape[:-1], nb, SCAN_BASE)
    inner = blocked_cumsum(blocks)
    outer = blocked_cumsum(inner[..., -1])
    carry = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                      -1)
    out = inner + carry[..., None]
    return out.reshape(*x.shape[:-1], nb * SCAN_BASE)[..., :d]


def _rows(row_ptr, col, wgt, v, width):
    """Rows of vertices ``v`` [S] padded to ``width``: ids (PAD past the
    degree, so rows stay sorted), weights (0 past it), degrees. An id
    outside the graph (a draw past the live lanes gives PAD) has no row."""
    n = row_ptr.shape[0] - 1
    inside = (v >= 0) & (v < n)
    at = torch.where(inside, v, 0)
    lo = row_ptr[at]
    deg = torch.where(inside, row_ptr[at + 1] - lo, 0)
    lane = torch.arange(width, device=v.device)
    live = lane[None, :] < deg[:, None]
    at = torch.where(live, lo[:, None] + lane[None, :], 0)
    ids = torch.where(live, col[at].long(), PAD)
    w = torch.where(live, wgt[at], 0.0)
    return ids, w, deg


def first_step(row_ptr, col, wgt, starts, wkeys, width):
    """Step 0: the first-order Vose draw at each start. Returns v1."""
    ids, w, deg = _rows(row_ptr, col, wgt, starts, width)
    prob = np.ones(tuple(w.shape), np.float32)
    alias = np.zeros(tuple(w.shape), np.int64)
    for i, (row, d) in enumerate(zip(w.cpu().numpy(), deg.tolist())):
        prob[i, :d], alias[i, :d] = vose(row[:d])
    prob = torch.from_numpy(prob).to(w.device)
    alias = torch.from_numpy(alias).to(w.device)
    k = fold(wkeys, 0)
    width_f = torch.clamp(deg, min=1)
    slot = (scalar_uniform(child(k, 0)) * width_f.to(torch.float32)
            ).to(torch.int64)
    slot = torch.minimum(slot, width_f - 1)
    u = scalar_uniform(child(k, 1))
    p = torch.gather(prob, 1, slot[:, None])[:, 0]
    a = torch.gather(alias, 1, slot[:, None])[:, 0]
    slot = torch.where(u >= p, a, slot)
    v1 = torch.gather(ids, 1, slot[:, None])[:, 0]
    return torch.where(deg > 0, v1, starts)


def second_order_step(row_ptr, col, wgt, u, v, rand, p: float, q: float,
                      width: int, dtype=torch.float32):
    """One exact (p, q) draw per walker at v, having come from u:
    alpha * w over N(v) with alpha = 1/p back to u, 1 for a common
    neighbour of u, 1/q otherwise, the blocked prefix sum, and the first
    lane whose sum exceeds ``rand * total``. A walker at a vertex of
    degree 0 stays."""
    cand, w, deg = _rows(row_ptr, col, wgt, v, width)
    prev, _, _ = _rows(row_ptr, col, wgt, u, width)
    at = torch.searchsorted(prev, cand).clamp(max=width - 1)
    common = (torch.gather(prev, 1, at) == cand) & (cand != PAD)
    inv_p = torch.tensor(float(np.float32(1.0 / p)), dtype=dtype,
                         device=v.device)
    inv_q = torch.tensor(float(np.float32(1.0 / q)), dtype=dtype,
                         device=v.device)
    one = torch.ones((), dtype=dtype, device=v.device)
    alpha = torch.where(cand == u[:, None], inv_p,
                        torch.where(common, one, inv_q))
    valid = cand != PAD
    prob = torch.where(valid, alpha * w.to(dtype), torch.zeros_like(alpha))
    cum = blocked_cumsum(prob)
    target = rand.to(dtype)[:, None] * cum[:, -1:]
    slot = ((cum <= target) & valid).sum(-1).clamp(max=width - 1)
    nxt = torch.gather(cand, 1, slot[:, None])[:, 0]
    return torch.where(deg > 0, nxt, v)


def walks(row_ptr, col, wgt, starts, walker_ids, seeds, length: int,
          p: float, q: float, dtype=torch.float32) -> torch.Tensor:
    """The node2vec walks of the given walkers, [S, length] int64 (column
    0 the first sampled step). Walker i draws under the keys
    ``fold(fold(key_of(seeds[i]), walker_ids[i]), step)``; ``dtype`` is
    the precision of the second-order draw."""
    dev = row_ptr.device
    starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    ids = torch.as_tensor(walker_ids, dtype=torch.int64, device=dev)
    width = max(int((row_ptr[1:] - row_ptr[:-1]).max()), 1)
    wkeys = fold(key_of(seeds, dev), ids)
    v = first_step(row_ptr, col, wgt, starts, wkeys, width)
    u = starts
    cols = [v]
    for s in range(1, length):
        k = child(fold(wkeys, s), 0)
        nxt = second_order_step(row_ptr, col, wgt, u, v, scalar_uniform(k),
                                p, q, width, dtype)
        u, v = v, nxt
        cols.append(nxt)
    return torch.stack(cols, 1)


# ----------------------------------------------------------------- SGNS --

def sgns_pairs(walk: torch.Tensor, window: int):
    """(center, context) of every ordered pair within the window of each
    walk, by offset: for each offset the forward then the backward pairs;
    a pair of a vertex with itself is not valid."""
    length = walk.shape[1]
    cs, xs = [], []
    for off in range(1, min(window, length - 1) + 1):
        a = walk[:, :length - off].reshape(-1)
        b = walk[:, off:].reshape(-1)
        cs += [a, b]
        xs += [b, a]
    c, x = torch.cat(cs), torch.cat(xs)
    return c, x, c != x


def init_tables(seed: int, vocab: int, dim: int, device):
    """emb_in = (u - 0.5) * 2 / sqrt(dim) over the first child's uniforms
    (float32, in that order of operations); emb_out = 0."""
    k1 = child(key_of(seed, device), 0)
    u = shaped(k1, vocab * dim, unit_float, torch.float32)
    scale = 1.0 / torch.sqrt(torch.tensor(float(dim), dtype=torch.float32,
                                          device=device))
    emb_in = ((u - 0.5) * 2 * scale).reshape(vocab, dim)
    return emb_in, torch.zeros_like(emb_in)


def negatives(key, prob: torch.Tensor, alias: torch.Tensor, b: int, k: int):
    """A [b, k] block of negatives from the alias table: a slot from the
    first child's randint, its alias where the second child's uniform is
    at least the slot's probability."""
    vocab = prob.shape[0]
    slots = randint_below(child(key, 0), b * k, vocab)
    u = shaped(child(key, 1), b * k, unit_float, torch.float32)
    return torch.where(u >= prob[slots], alias[slots], slots).reshape(b, k)


def sgns_steps(walk0: torch.Tensor, cfg: dict, seed: int,
               steps: int | None = None, dtype=torch.float64,
               fault: str | None = None, first: int = 3) -> dict:
    """The dense-Adam SGNS steps of a trainer seeded ``seed`` on its first
    round's walks ``walk0`` [W, L]: the whole round, or its first
    ``steps``.

    ``cfg`` holds vocab, dim, window, negatives, batch_size, lr, power,
    adam_b1, adam_b2, adam_eps. Returns each step's loss (the masked mean
    of -log sigma(c.p) - sum log sigma(-c.n)), each leaf's gradient norm
    at each of the ``first`` steps (``grads``), each leaf's parameter
    change after them (``change``) and after the last step
    (``round_change``).

    ``fault`` plants a fault for the check's upper readings:
    ``"half_batch"`` trains on the batch's first half, the mean over it;
    ``"frozen"`` leaves the tables as they are."""
    dev = walk0.device
    vocab, dim = cfg["vocab"], cfg["dim"]
    b, k = cfg["batch_size"], cfg["negatives"]
    counts = np.bincount(walk0.reshape(-1).cpu().numpy(),
                         minlength=vocab).astype(np.float64)
    freq = counts ** cfg["power"]
    if freq.sum() == 0:
        freq = np.ones(vocab)
    prob_np, alias_np = vose(freq)
    prob = torch.from_numpy(prob_np).to(dev)
    alias = torch.from_numpy(alias_np).long().to(dev)
    c, x, valid = sgns_pairs(walk0.long(), cfg["window"])
    n_pairs = c.shape[0]
    if steps is None:
        steps = -(-n_pairs // b)
    tkey = key_of(seed, dev)
    rkey = fold(fold(tkey, 0), 0)           # round 0, epoch 0
    perm = shuffle(child(rkey, 0), n_pairs)
    skey = child(rkey, 1)
    emb_in, emb_out = init_tables(seed, vocab, dim, dev)
    params = {"emb_in": emb_in.to(dtype), "emb_out": emb_out.to(dtype)}
    start = {n: t.clone() for n, t in params.items()}
    del emb_in, emb_out
    mu = {n: torch.zeros_like(t) for n, t in params.items()}
    nu = {n: torch.zeros_like(t) for n, t in params.items()}
    grads = {n: torch.zeros_like(t) for n, t in params.items()}
    b1, b2, eps, lr = (cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"],
                       cfg["lr"])
    losses, grad_norms = [], {n: [] for n in params}
    change = None
    lane = torch.arange(b, device=dev)

    def change_now():
        return {n: float(torch.linalg.vector_norm(
            (params[n] - start[n]).to(torch.float64))) for n in params}

    for s in range(steps):
        idx = perm[s * b:(s + 1) * b]
        idx = torch.cat([idx, idx.new_zeros(b - idx.shape[0])])
        center, pos = c[idx], x[idx]
        keep = (valid[idx] & ((s * b + lane) < n_pairs)).to(dtype)
        neg = negatives(fold(skey, s), prob, alias, b, k)
        if fault == "half_batch":
            keep = keep * (lane < b // 2).to(dtype)
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
        grads["emb_in"].zero_().index_add_(0, center,
                                           cp * po + (cn * no).sum(1))
        grads["emb_out"].zero_().index_add_(0, pos, cp * ci).index_add_(
            0, neg.reshape(-1), (cn * ci[:, None, :]).reshape(-1, dim))
        if s < first:
            for n, g in grads.items():
                grad_norms[n].append(float(torch.linalg.vector_norm(
                    g, dtype=torch.float64)))
        t = s + 1
        for n, g in grads.items():
            mu[n].mul_(b1).add_(g, alpha=1 - b1)
            nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            if fault == "frozen":
                continue
            den = (nu[n] / (1 - b2 ** t)).sqrt_().add_(eps)
            params[n].addcdiv_(mu[n], den, value=-lr / (1 - b1 ** t))
            del den
        if t == first:
            change = change_now()
    end = change_now()
    return {"losses": losses, "grads": grad_norms,
            "change": change if change is not None else end,
            "round_change": end, "n_pairs": int(n_pairs)}
