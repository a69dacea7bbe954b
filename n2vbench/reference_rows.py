"""The plain reference for SGNS trained by lazy row-Adam: the trainer's
``shard_tables`` path (``torch.optim.SparseAdam``'s rule).

Plain PyTorch in float64, beside ``reference.py`` and built from its
helpers: the initial tables, the pairs, the pair permutation, the
unigram^power negatives' Vose table and the negatives under the same
(round, epoch, step) keys as dense training. It imports nothing of the
program. Each step takes the batch's loss and its gradients as
``reference.sgns_steps`` does; only the optimizer differs.

Lazy Adam keeps one step count t for the run. At step t it names rows:
for ``emb_in`` the distinct ids of the batch's centre column, for
``emb_out`` the distinct ids of its context and negative columns. A
masked pair (a vertex with itself) and a pad slot past the round's pairs
still name their rows, as every looked-up row is in SparseAdam's sparse
gradient. Only the named rows' moments update, and only they step, by
the bias-corrected ratio at t; every other row keeps its moments and its
values bit for bit.

Faults, planted for the check's upper readings: ``"half_batch"`` trains
on the batch's first half, the mean over it; ``"frozen"`` leaves the
tables as they are (the moments still update); ``"dense"`` decays every
row's moments at every step and moves every row that has moments: dense
Adam in place of lazy.
"""
from __future__ import annotations

import numpy as np
import torch

from n2vbench.reference import (child, fold, init_tables, key_of,
                                negatives, sgns_pairs, shuffle, vose)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TABLES = ("emb_in", "emb_out")
FAULTS = ("half_batch", "frozen", "dense")


def alias_of(counts: np.ndarray, power: float, device):
    """The negatives' Vose table of the cumulative walk counts [V]."""
    freq = np.asarray(counts, np.float64) ** power
    if freq.sum() == 0:
        freq = np.ones(len(freq))
    prob, alias = vose(freq)
    return (torch.from_numpy(prob).to(device),
            torch.from_numpy(alias).long().to(device))


def round_batches(walk: torch.Tensor, cfg: dict, seed: int,
                  round_index: int, counts: np.ndarray):
    """The steps of round ``round_index`` (its one epoch) of a trainer
    seeded ``seed``, on that round's walks [W, L] with the cumulative
    walk counts up to and including it: per step (centre [B], context
    [B], negatives [B, K], the pair weight [B]: 0 for a masked pair or a
    pad slot)."""
    dev = walk.device
    b, k = cfg["batch_size"], cfg["negatives"]
    prob, alias = alias_of(counts, cfg["power"], dev)
    c, x, valid = sgns_pairs(walk.long(), cfg["window"])
    n_pairs = c.shape[0]
    rkey = fold(fold(key_of(seed, dev), round_index), 0)     # epoch 0
    perm = shuffle(child(rkey, 0), n_pairs)
    skey = child(rkey, 1)
    lane = torch.arange(b, device=dev)
    for s in range(-(-n_pairs // b)):
        idx = perm[s * b:(s + 1) * b]
        idx = torch.cat([idx, idx.new_zeros(b - idx.shape[0])])
        keep = valid[idx] & ((s * b + lane) < n_pairs)
        yield c[idx], x[idx], negatives(fold(skey, s), prob, alias, b, k), \
            keep


def named_rows(center, pos, neg) -> dict:
    """The rows a step names, by table: sorted distinct ids."""
    return {"emb_in": torch.unique(center),
            "emb_out": torch.unique(torch.cat([pos, neg.reshape(-1)]))}


def distinct_rows(walk: torch.Tensor, cfg: dict, seed: int,
                  round_index: int, counts: np.ndarray) -> dict:
    """The rows round ``round_index``'s steps name, summed over its
    steps: ``distinct`` (centre rows plus context and negative rows) and
    ``steps``."""
    distinct = steps = 0
    for center, pos, neg, _ in round_batches(walk, cfg, seed, round_index,
                                             counts):
        distinct += sum(int(r.numel())
                        for r in named_rows(center, pos, neg).values())
        steps += 1
    return {"distinct": distinct, "steps": steps}


def sgns_rows_steps(rounds, cfg: dict, seed: int, dtype=torch.float64,
                    fault: str | None = None) -> dict:
    """Lazy row-Adam SGNS over whole rounds of walks, each [W, L], as one
    trainer seeded ``seed`` consumes them in order (one epoch a round).

    ``cfg`` holds vocab, dim, window, negatives, batch_size, lr, power,
    adam_b1, adam_b2, adam_eps. Returns each step's loss (the masked mean
    of -log sigma(c.p) - sum log sigma(-c.n)), the tables after the last
    step (``tables``, in ``dtype``) and, by table, the rows some step
    named (``named``, a [V] mask)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    rounds = list(rounds)
    dev = rounds[0].device
    vocab, dim = cfg["vocab"], cfg["dim"]
    b = cfg["batch_size"]
    emb_in, emb_out = init_tables(seed, vocab, dim, dev)
    params = {"emb_in": emb_in.to(dtype), "emb_out": emb_out.to(dtype)}
    del emb_in, emb_out
    mu = {n: torch.zeros_like(t) for n, t in params.items()}
    nu = {n: torch.zeros_like(t) for n, t in params.items()}
    grads = {n: torch.zeros_like(t) for n, t in params.items()}
    named = {n: torch.zeros(vocab, dtype=torch.bool, device=dev)
             for n in TABLES}
    b1, b2, eps, lr = (cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"],
                       cfg["lr"])
    counts = np.zeros(vocab, np.float64)
    lane = torch.arange(b, device=dev)
    losses = []
    t = 0
    for r, walk in enumerate(rounds):
        counts += np.bincount(walk.reshape(-1).cpu().numpy(),
                              minlength=vocab)
        for center, pos, neg, keep in round_batches(walk, cfg, seed, r,
                                                    counts):
            keep = keep.to(dtype)
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
            del ci, po, no, cp, cn
            t += 1
            for n, rows in named_rows(center, pos, neg).items():
                named[n][rows] = True
                if fault == "dense":
                    rows = slice(None)
                g = grads[n][rows]
                m = mu[n][rows] * b1 + g * (1 - b1)
                v = nu[n][rows] * b2 + g * g * (1 - b2)
                mu[n][rows] = m
                nu[n][rows] = v
                if fault == "frozen":
                    continue
                den = (v / (1 - b2 ** t)).sqrt_().add_(eps)
                params[n][rows] += m / den * (-lr / (1 - b1 ** t))
                del g, m, v, den
    return {"losses": losses, "tables": params, "named": named}
