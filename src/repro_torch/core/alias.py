"""Vose alias method — port of ``repro.core.alias``.

``build_alias`` / ``build_alias_rows`` run on the host (numpy) and
produce tables identical to the JAX package's, bit for bit: the same pops and
pushes in the same order, the same float64 arithmetic (Python floats are
IEEE doubles, like numpy's float64 scalars). ``alias_sample`` is the batched
O(1) draw on tensors, with the JAX package's RNG calls.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr


def build_alias(w: np.ndarray):
    """Classic Vose construction for one row -> (prob[f32], alias[i32])."""
    k = len(w)
    prob = np.zeros(k, dtype=np.float32)
    alias = np.zeros(k, dtype=np.int32)
    if k == 0:
        return prob, alias
    total = float(w.sum())
    if total <= 0:
        prob[:] = 1.0
        alias[:] = np.arange(k)
        return prob, alias
    scaled = (w.astype(np.float64) * (k / total)).tolist()
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    prob_l = [1.0] * k
    alias_l = list(range(k))
    while small and large:
        s, l = small.pop(), large.pop()
        prob_l[s] = scaled[s]
        alias_l[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    # entries left on either stack keep prob 1.0 and alias themselves
    prob[:] = prob_l
    alias[:] = alias_l
    return prob, alias


def build_alias_rows(wrows: np.ndarray):
    """Batched Vose over padded weight rows ``[R, D]`` (0-padded, pads strictly
    trailing). Each table covers exactly the row's live slots, so draws use
    ``width = deg`` and do not depend on the padded layout."""
    wrows = np.asarray(wrows, dtype=np.float64)
    r, d = wrows.shape
    prob = np.zeros((r, d), dtype=np.float32)
    alias = np.zeros((r, d), dtype=np.int32)
    if r == 0 or d == 0:
        return prob, alias
    live = (wrows > 0).sum(axis=1)
    for i in np.nonzero(live > 0)[0]:
        k = int(live[i])
        p, a = build_alias(wrows[i, :k])
        prob[i, :k], alias[i, :k] = p, a
    return prob, alias


def alias_sample(keys: torch.Tensor, prob_rows: torch.Tensor,
                 alias_rows: torch.Tensor, width: torch.Tensor
                 ) -> torch.Tensor:
    """Batched O(1) alias draw: keys [W, 2], tables [W, D], width [W] (the
    live degree). Returns the sampled slot per walker, [W] int64."""
    return alias_pick(*alias_uniforms(keys), prob_rows, alias_rows, width)


def alias_uniforms(keys: torch.Tensor):
    """The RNG of :func:`alias_sample`: the slot's and the accept test's
    uniforms, [W] each, from keys [W, 2]."""
    sub = jr.split(keys)                                  # [W, 2, 2]
    return jr.uniform(sub[:, 0]), jr.uniform(sub[:, 1])


def alias_pick(u_slot: torch.Tensor, u_accept: torch.Tensor,
               prob_rows: torch.Tensor, alias_rows: torch.Tensor,
               width: torch.Tensor) -> torch.Tensor:
    """The rest of :func:`alias_sample`, given its uniforms."""
    width = torch.clamp(width.to(torch.int32), min=1)
    slot = (u_slot * width.to(torch.float32)).to(torch.int32)
    slot = torch.minimum(slot, width - 1).long()
    p = torch.gather(prob_rows, 1, slot[:, None])[:, 0]
    a = torch.gather(alias_rows, 1, slot[:, None])[:, 0].long()
    return torch.where(u_accept >= p, a, slot)
