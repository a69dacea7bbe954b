"""Walk corpus -> SGNS training batches — port of ``repro.data.corpus``.

Host-side numpy, as in the JAX package: sliding-window (center, context)
pairs and unigram^0.75 negative sampling through the port's own Vose alias
tables (``repro_torch.core.alias.build_alias``, identical to the JAX
package's), so batches equal the reference's integer for integer.
``walks_to_lm_tokens`` belongs to the LM slice and is not ported yet.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.core.alias import build_alias


def sgns_pairs(walks: np.ndarray,
               window: int) -> Tuple[np.ndarray, np.ndarray]:
    """All (center, context) pairs within +-window along each walk.

    walks: [W, L] int32 (self-loop tails from dead-end walks are kept; the
    self-pairs they make are filtered out).
    """
    w, l = walks.shape
    centers, contexts = [], []
    for off in range(1, window + 1):
        if off >= l:
            break
        a = walks[:, :-off].reshape(-1)
        b = walks[:, off:].reshape(-1)
        centers.append(a)
        contexts.append(b)
        centers.append(b)
        contexts.append(a)
    c = np.concatenate(centers) if centers else np.zeros(0, np.int32)
    x = np.concatenate(contexts) if contexts else np.zeros(0, np.int32)
    keep = c != x
    return c[keep].astype(np.int32), x[keep].astype(np.int32)


class NegativeSampler:
    """Unigram^0.75 negative sampler over the walk corpus (word2vec's
    choice), via the same Vose alias tables as the walk engine."""

    def __init__(self, walks: np.ndarray, vocab: int, power: float = 0.75):
        counts = np.bincount(walks.reshape(-1), minlength=vocab).astype(
            np.float64)
        freq = counts ** power
        if freq.sum() == 0:
            freq = np.ones(vocab)
        self.prob, self.alias = build_alias(freq)
        self.vocab = vocab

    def sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        slots = rng.integers(0, self.vocab, size=shape)
        u = rng.random(shape)
        take = u >= self.prob[slots]
        return np.where(take, self.alias[slots], slots).astype(np.int32)


def walks_to_sgns_batches(walks: np.ndarray, vocab: int, window: int,
                          negatives: int, batch_size: int, seed: int = 0,
                          epochs: int = 1) -> Iterator[dict]:
    """Yield padded, shuffled SGNS batches of numpy arrays: center/pos [B],
    neg [B, K], valid [B] (the last batch is padded; its padded rows draw
    no negatives)."""
    centers, contexts = sgns_pairs(walks, window)
    sampler = NegativeSampler(walks, vocab)
    rng = np.random.default_rng(seed)
    n = centers.shape[0]
    for _ in range(epochs):
        perm = rng.permutation(n)
        for lo in range(0, n, batch_size):
            idx = perm[lo:lo + batch_size]
            b = idx.shape[0]
            pad = batch_size - b
            c = np.pad(centers[idx], (0, pad))
            p = np.pad(contexts[idx], (0, pad))
            neg = np.zeros((batch_size, negatives), np.int32)
            if b:
                neg[:b] = sampler.sample(rng, (b, negatives))
            valid = np.pad(np.ones(b, np.float32), (0, pad))
            yield {"center": c, "pos": p, "neg": neg, "valid": valid}
