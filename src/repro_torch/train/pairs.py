"""Device-side SGNS corpus ops — port of ``repro.train.pairs``.

The walks array stays resident on the device and the corpus never exists
on the host:

* :func:`device_pairs` — window-offset gathers over the resident ``[W, L]``
  walks. The same pair stream, in the same order, as the host
  ``sgns_pairs`` before its ``c != x`` filter; self-pairs come back as a
  validity mask instead of being compacted out, so every shape is fixed.
* :func:`device_negatives` — O(1) Vose alias draws from the unigram^0.75
  table over a whole ``[B, K]`` block, with the JAX package's
  ``randint`` / ``uniform`` bits.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr


def num_pairs(walkers: int, length: int, window: int) -> int:
    """Pair count of a [walkers, length] round: for each offset
    ``off in 1..min(window, length-1)`` there are ``2 * walkers *
    (length - off)`` ordered pairs (both directions)."""
    o = min(window, length - 1)
    return 2 * walkers * (o * length - o * (o + 1) // 2)


def device_pairs(walks: torch.Tensor, window: int):
    """All (center, context) pairs within +-window along each walk.

    walks: [W, L] int32. Returns ``(centers, contexts, valid)``, each
    ``[num_pairs(W, L, window)]``; ``valid`` masks self-pairs.
    """
    w, l = walks.shape
    centers, contexts = [], []
    for off in range(1, min(window, l - 1) + 1):
        a = walks[:, :l - off].reshape(-1)
        b = walks[:, off:].reshape(-1)
        centers.append(a)
        contexts.append(b)
        centers.append(b)
        contexts.append(a)
    if not centers:
        z = torch.zeros(0, dtype=torch.int32, device=walks.device)
        return z, z, torch.zeros(0, dtype=torch.bool, device=walks.device)
    c = torch.cat(centers)
    x = torch.cat(contexts)
    return c, x, c != x


def device_negatives(key: torch.Tensor, prob: torch.Tensor,
                     alias: torch.Tensor, shape) -> torch.Tensor:
    """Draw ``shape`` negatives from the alias table ``(prob [V],
    alias [V])``: ``k1, k2 = split(key)``, a slot by ``randint(k1)``, its
    alias taken where ``uniform(k2) >= prob[slot]``. int32."""
    vocab = prob.shape[0]
    k1, k2 = jr.split(key)
    slots = jr.randint(k1, shape, 0, vocab).long()
    u = jr.uniform(k2, shape)
    return torch.where(u >= prob[slots], alias[slots].long(),
                       slots).to(torch.int32)
