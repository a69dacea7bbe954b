"""Single-device walk engine (FN-Base / FN-Cache / FN-Approx) — port of
``repro.core.walk``, the substrate of two ``WalkEngine`` backends:

* ``"reference"`` — all sampling in plain PyTorch;
* ``"fused"``     — the exact second-order draw runs in the
  ``node2vec_step`` CUDA kernel, which reads v's and u's rows in place
  from the layout, and with ``WalkPlan.pipeline`` (exact mode,
  FN-Base layout) the whole walk runs in the ``node2vec_walk`` kernel.

The walk is vectorised over walkers; a Python loop over supersteps takes
the place of ``lax.scan``. RNG: the key of walker ``i`` at step ``s`` is
``fold_in(fold_in(seed, i), s)``, a pure function of (walker, step), so
every backend — and the JAX package — draws the same walks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.core.graph import PAD_ID, PaddedGraph
from repro_torch.engine.sampler import (HotContext, Sampler, first_order_slots,
                                        split_keys)

_FILL = {"adj": PAD_ID, "wgt": 0.0, "alias_p": 0.0, "alias_i": 0}


def walker_key(seed_key: torch.Tensor, walker_id: torch.Tensor,
               step) -> torch.Tensor:
    """Layout-independent per-(walker, step) keys: [W] ids -> [W, 2]."""
    return jr.fold_in(jr.fold_in(seed_key, walker_id), step)


def unified_row(pg: PaddedGraph, v: torch.Tensor,
                fields=("adj", "wgt", "alias_p", "alias_i")):
    """Full-width (``hot_cap``) rows of a [W] batch of vertex ids.

    Returns one [W, hot_cap] tensor per requested field, then ``is_hot``
    [W]. Hot vertices read the hot cache (exact, full degree); cold vertices
    read their capped row, padded out to ``hot_cap``.
    """
    hpos = pg.hot_pos[v]
    is_hot = hpos >= 0
    h = torch.clamp(hpos, min=0).long()
    out = []
    for f in fields:
        cold = F.pad(getattr(pg, f)[v], (0, pg.hot_cap - pg.cap),
                     value=_FILL[f])
        out.append(torch.where(is_hot[:, None], getattr(pg, "hot_" + f)[h],
                               cold))
    return (*out, is_hot)


def _gather(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return torch.gather(rows, 1, slot.long()[:, None])[:, 0]


def _first_step(pg: PaddedGraph, starts: torch.Tensor,
                walker_keys: torch.Tensor):
    """Step 0: first-order draw from static edge weights. Returns v1 and
    the start rows (the prev rows of step 1)."""
    ids0, ap0, ai0, _ = unified_row(pg, starts, ("adj", "alias_p",
                                                 "alias_i"))
    deg0 = pg.deg[starts]
    slot0 = first_order_slots(jr.fold_in(walker_keys, 0), ap0, ai0, deg0)
    v1 = torch.where(deg0 > 0, _gather(ids0, slot0), starts)
    return v1, ids0


def _fused_step(pg: PaddedGraph, sampler: Sampler, keys: torch.Tensor,
                u: torch.Tensor, v: torch.Tensor, ids, hot) -> torch.Tensor:
    """One superstep of the fused backend: the exact draw and its next
    vertex from the ``node2vec_step`` kernel's layout entry (v's and u's
    rows read in place), then, in the approx modes, the alias draw on v's
    full-width ids where the O(1) path is taken."""
    from repro_torch.kernels.node2vec_step import node2vec_step_layout
    k_exact, k_approx = split_keys(keys)
    slot, nxt = node2vec_step_layout(pg, u, v, jr.uniform(k_exact),
                                     sampler.p, sampler.q)
    choice = sampler.with_alias(slot, k_approx, hot)
    if choice.use_alias is None:
        return nxt
    alias_nxt = torch.where(pg.deg[v] > 0, _gather(ids, choice.slot_alias),
                            v)
    return torch.where(choice.use_alias, alias_nxt, nxt)


def run_reference(pg: PaddedGraph, starts: torch.Tensor,
                  walker_ids: torch.Tensor, seed_key: torch.Tensor,
                  sampler: Sampler, length: int) -> torch.Tensor:
    """Walk ``starts`` [W] int32 for ``length`` steps -> [W, length] int32
    (column 0 is the first sampled step).

    With ``sampler.fused`` the exact draw reads the layout in place, so
    exact mode builds no ``[W, hot_cap]`` rows and the approx modes build
    only the ids and alias rows of the O(1) path; otherwise every step
    builds v's full-width rows and draws on them."""
    wkeys = jr.fold_in(seed_key, walker_ids)
    v1, prev = _first_step(pg, starts, wkeys)
    cols = [v1]
    u, v = starts, v1
    approx = sampler.mode != "exact"
    if sampler.fused:
        fields = ("adj", "alias_p", "alias_i") if approx else ()
    else:
        fields = ("adj", "wgt", "alias_p", "alias_i") if approx else \
            ("adj", "wgt")
    for s in range(1, length):
        keys = jr.fold_in(wkeys, s)
        rows = dict(zip(fields + ("is_hot",), unified_row(pg, v, fields))) \
            if fields else {}
        hot = None
        if approx:
            hot = HotContext(
                is_hot_v=rows["is_hot"], is_hot_u=pg.hot_pos[u] >= 0,
                deg_u=pg.deg[u], deg_v=pg.deg[v],
                w_min_v=pg.w_min[v], w_max_v=pg.w_max[v],
                alias_p=rows["alias_p"], alias_i=rows["alias_i"],
                alias_deg=pg.deg[v])
        if sampler.fused:
            nxt = _fused_step(pg, sampler, keys, u, v, rows.get("adj"), hot)
        else:
            ids = rows["adj"]
            choice = sampler.choose(keys, ids, rows["wgt"], u, prev, hot)
            nxt = torch.where(pg.deg[v] > 0, _gather(ids, choice.slot()), v)
            prev = ids
        u, v = v, nxt
        cols.append(nxt)
    return torch.stack(cols, dim=1)


def step_uniforms(seed_key: torch.Tensor, walker_ids: torch.Tensor,
                  length: int) -> torch.Tensor:
    """The exact draw's uniform of every (walker, step >= 1): [W, length-1]
    float32, the same numbers ``Sampler.choose`` draws step by step."""
    steps = torch.arange(1, length, dtype=torch.int64,
                         device=walker_ids.device)
    keys = walker_key(seed_key, walker_ids[:, None], steps[None, :])
    return jr.uniform(jr.split(keys)[..., 0, :])


def run_fused_persistent(pg: PaddedGraph, starts: torch.Tensor,
                         walker_ids: torch.Tensor, seed_key: torch.Tensor,
                         sampler: Sampler, length: int) -> torch.Tensor:
    """Fused backend with ``WalkPlan.pipeline``: one ``node2vec_walk``
    launch runs every second-order superstep, carrying each walker's prev
    row on chip instead of re-reading it per step.

    Requires exact mode and the FN-Base layout (no hot set; the engine
    checks). Step 0 and the per-(walker, step) uniforms are computed here,
    so walks equal :func:`run_reference`'s.
    """
    from repro_torch.kernels.node2vec_step import node2vec_walk

    wkeys = jr.fold_in(seed_key, walker_ids)
    v1, _ = _first_step(pg, starts, wkeys)
    if length == 1:
        return v1[:, None]
    rand = step_uniforms(seed_key, walker_ids, length)
    tail = node2vec_walk(pg.adj, pg.wgt, pg.deg, starts, v1, rand,
                         sampler.p, sampler.q)
    return torch.cat([v1[:, None], tail], dim=1)
