"""Second-order node2vec transition probabilities on demand — port of
``repro.core.transition``.

The walk moved u -> v; for every candidate x in N(v):

    alpha(u, v, x) = 1/p if x == u, 1 if x in N(u), 1/q otherwise
    pi_vx = alpha * w_vx   (normalised over N(v))

Every function here is batched over a leading walker axis. Scalars derived
from p and q are rounded to float32 once, as JAX rounds its weak-typed
Python scalars; expressions of Python scalars alone are evaluated in double
first, as in the JAX source.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.graph import PAD_ID, CSRGraph


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def membership(prev_sorted: torch.Tensor, cand_ids: torch.Tensor
               ) -> torch.Tensor:
    """Is each candidate in its walker's sorted row? prev_sorted [W, DP]
    (ascending, PAD_ID padded), cand_ids [W, D] -> [W, D] bool."""
    dp = prev_sorted.shape[-1]
    pos = torch.searchsorted(prev_sorted.contiguous(), cand_ids.contiguous())
    pos = torch.clamp(pos, max=dp - 1)
    hit = torch.gather(prev_sorted, 1, pos) == cand_ids
    return hit & (cand_ids != PAD_ID)


def unnormalized_probs(cand_ids: torch.Tensor, cand_w: torch.Tensor,
                       u: torch.Tensor, prev_sorted: torch.Tensor,
                       p: float, q: float) -> torch.Tensor:
    """alpha_pq * w over candidate rows: [W, D], [W, D], [W], [W, DP]."""
    is_u = cand_ids == u[:, None]
    common = membership(prev_sorted, cand_ids)
    one = _f32(1.0, cand_w)
    alpha = torch.where(is_u, _f32(1.0 / p, cand_w),
                        torch.where(common, one, _f32(1.0 / q, cand_w)))
    valid = cand_ids != PAD_ID
    return torch.where(valid, alpha * cand_w, _f32(0.0, cand_w))


def approx_gap(deg_u: torch.Tensor, deg_v: torch.Tensor,
               w_min_v: torch.Tensor, w_max_v: torch.Tensor,
               p: float, q: float) -> torch.Tensor:
    """Width of the [LB, UB] interval of one transition probability at v
    from scalar summaries only (paper Eq. 2-3, generalised to any p, q)."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    f = lambda x: _f32(x, w_min_v)                       # noqa: E731
    dv = torch.clamp(deg_v.to(torch.float32), min=2.0)
    m = torch.minimum(deg_u.to(torch.float32), dv - f(1.0))
    base = f(inv_p) + (dv - f(1.0)) * f(inv_q)
    spread = m * f(1.0 - inv_q)
    den_hi = w_max_v * (base + torch.clamp(spread, min=0.0))
    den_lo = w_min_v * (base + torch.clamp(spread, max=0.0))
    num_hi = f(max(1.0, inv_q)) * w_max_v
    num_lo = f(min(1.0, inv_q)) * w_min_v
    tiny = f(1e-30)
    return (num_hi / torch.maximum(den_lo, tiny)
            - num_lo / torch.maximum(den_hi, tiny))


def brute_force_probs(g: CSRGraph, u: int, v: int, p: float,
                      q: float) -> Dict[int, float]:
    """Python-set oracle for tests: exact normalised transition probs at v
    given previous vertex u."""
    nu = set(int(x) for x in g.neighbors(u))
    probs = {}
    for x, w in zip(g.neighbors(v), g.weights(v)):
        x = int(x)
        if x == u:
            a = 1.0 / p
        elif x in nu:
            a = 1.0
        else:
            a = 1.0 / q
        probs[x] = probs.get(x, 0.0) + a * float(w)
    total = sum(probs.values())
    return {x: pw / total for x, pw in probs.items()} if total > 0 else {}
