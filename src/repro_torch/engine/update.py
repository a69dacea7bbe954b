"""Shard-local device updates for the walk engine — port of
``repro.engine.update``.

The host side of an incremental update is the CSR patch
(``repro_torch.data.deltas.apply_delta_csr``); this module is the device
side: given the patched CSR and the affected vertex set, recompute only
the affected rows' packed adjacency, alias tables and (FN-Cache) hot
cache entries, and splice them into a **new**
:class:`~repro_torch.core.graph.PaddedGraph`. The old layout is left as it
was (``index_copy`` out of place on each touched tensor, as JAX's
functional ``.at[rows].set``): a round already enqueued, or another engine
holding it, keeps walking the graph it was given.

The patch falls back to a full relayout (a fresh ``PaddedGraph.build``)
exactly when the layout can no longer represent the new graph as a
from-scratch build at the same plan would:

* hot-set membership changed (a vertex crossed ``deg > cap``);
* ``plan.cap is None`` (FN-Base) and the max degree grew past the row
  width;
* ``plan.hot_cap is None`` and an affected hot vertex outgrew the hot row
  width.

Rows are re-packed exactly as the from-scratch packer packs them, and
``build_alias_rows`` is row-independent, so a patched layout equals the
from-scratch layout field by field whenever no relayout was needed.

The JAX package pads each scatter's row count to a power of two to bound
jit recompiles (``_pad_to_bucket``); eager torch compiles nothing, so the
rows are written once each, and the affected ids are unique.

:func:`patch_sharded` does the same for one rank's
:class:`~repro_torch.core.walk_distributed.ShardedGraph`: the affected rows
of its own block, and the affected hot rows, which every rank holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.alias import build_alias_rows
from repro_torch.core.graph import PAD_ID, CSRGraph, PaddedGraph
from repro_torch.core.walk_distributed import ShardedGraph
from repro_torch.data.deltas import PatchReport


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one ``WalkEngine.update`` did.

    ``invalidated_device_shards`` counts patch shards whose rows were
    rewritten (all of them on relayout); ``hot_rows_updated`` counts
    FN-Cache hot rows patched in place (never a relayout by itself).
    """
    patch: PatchReport
    version: int
    relayout: bool
    device_shards: int
    invalidated_device_shards: int
    hot_rows_updated: int

    @property
    def invalidated_fraction(self) -> float:
        return self.invalidated_device_shards / max(self.device_shards, 1)


def _pack_rows(g: CSRGraph, vertices: np.ndarray, width: int):
    """CSR slices -> [len(vertices), width] padded rows (the packer of
    ``PaddedGraph.build``, row for row)."""
    rows = np.full((len(vertices), width), PAD_ID, np.int32)
    wrows = np.zeros((len(vertices), width), np.float32)
    for i, v in enumerate(vertices.tolist()):
        lo, hi = int(g.row_ptr[v]), int(g.row_ptr[v + 1])
        d = min(hi - lo, width)
        rows[i, :d] = g.col[lo:lo + d]
        wrows[i, :d] = g.wgt[lo:lo + d]
    return rows, wrows


def _masked_min_max(adj: np.ndarray, wgt: np.ndarray, deg: np.ndarray):
    """Per-row min/max edge weight over live slots; 1.0 for isolated rows
    (the ``PaddedGraph.build`` convention)."""
    w_min = np.ones(adj.shape[0], np.float32)
    w_max = np.ones(adj.shape[0], np.float32)
    nz = deg > 0
    mask = adj != PAD_ID
    with np.errstate(invalid="ignore"):
        w_min[nz] = np.where(mask, wgt, np.inf).min(axis=1)[nz]
        w_max[nz] = np.where(mask, wgt, -np.inf).max(axis=1)[nz]
    return w_min, w_max


def _needs_relayout(g: CSRGraph, affected: np.ndarray, was_hot: np.ndarray,
                    cap: int, hot_cap: int, plan_cap, plan_hot_cap) -> bool:
    deg_new = g.deg
    now_hot = deg_new[affected] > cap
    if np.any(was_hot != now_hot):
        return True
    if plan_cap is None and g.max_degree > cap:
        return True
    if plan_hot_cap is None and now_hot.any() \
            and int(deg_new[affected[now_hot]].max()) > hot_cap:
        return True
    return False


def _spliced(old: torch.Tensor, rows: torch.Tensor,
             values: np.ndarray) -> torch.Tensor:
    """A copy of ``old`` with ``old[rows] = values`` (``old`` untouched)."""
    return old.index_copy(0, rows, torch.from_numpy(values).to(old.device))


def patch_padded(pg: PaddedGraph, g: CSRGraph, affected: np.ndarray,
                 plan_cap, plan_hot_cap):
    """Splice the affected rows of the patched CSR ``g`` into ``pg``.

    Returns ``(new_pg, relayout, hot_rows_updated)``. ``new_pg`` is a new
    layout on ``pg``'s device: the touched tensors are copies with the
    affected rows written, the untouched ones are shared with ``pg``; on a
    relayout it is a fresh ``PaddedGraph.build``. ``pg`` is never written.
    """
    aff = np.asarray(affected, np.int64)
    if not aff.size:
        return pg, False, 0
    hot_pos_h = pg.hot_pos.cpu().numpy()        # one sync per update
    was_hot = hot_pos_h[aff] >= 0
    if _needs_relayout(g, aff, was_hot, pg.cap, pg.hot_cap,
                       plan_cap, plan_hot_cap):
        return PaddedGraph.build(g, cap=plan_cap, hot_cap=plan_hot_cap,
                                 device=pg.device), True, 0

    deg_new = g.deg
    rows_adj, rows_wgt = _pack_rows(g, aff, pg.cap)
    ap, ai = build_alias_rows(rows_wgt)
    deg_aff = deg_new[aff]
    w_min_a, w_max_a = _masked_min_max(rows_adj, rows_wgt, deg_aff)

    hot_vs = aff[was_hot]
    h_pack = None
    if hot_vs.size:
        h_adj, h_wgt = _pack_rows(g, hot_vs, pg.hot_cap)
        h_ap, h_ai = build_alias_rows(h_wgt)
        # hot vertices' scalars come from the full-width hot row
        h_min, h_max = _masked_min_max(h_adj, h_wgt, deg_new[hot_vs])
        sel = np.searchsorted(aff, hot_vs)
        w_min_a[sel], w_max_a[sel] = h_min, h_max
        h_pack = (hot_pos_h[hot_vs], h_adj, h_wgt, h_ap, h_ai)

    rows = torch.from_numpy(aff).to(pg.device)
    new = dataclasses.replace(
        pg,
        adj=_spliced(pg.adj, rows, rows_adj),
        wgt=_spliced(pg.wgt, rows, rows_wgt),
        alias_p=_spliced(pg.alias_p, rows, ap),
        alias_i=_spliced(pg.alias_i, rows, ai),
        deg=_spliced(pg.deg, rows, deg_aff),
        w_min=_spliced(pg.w_min, rows, w_min_a),
        w_max=_spliced(pg.w_max, rows, w_max_a))
    if h_pack is None:
        return new, False, 0
    hpos, h_adj, h_wgt, h_ap, h_ai = h_pack
    hrows = torch.from_numpy(hpos.astype(np.int64)).to(pg.device)
    new = dataclasses.replace(
        new,
        hot_adj=_spliced(pg.hot_adj, hrows, h_adj),
        hot_wgt=_spliced(pg.hot_wgt, hrows, h_wgt),
        hot_alias_p=_spliced(pg.hot_alias_p, hrows, h_ap),
        hot_alias_i=_spliced(pg.hot_alias_i, hrows, h_ai))
    return new, False, int(hot_vs.size)


def patch_sharded(sg: ShardedGraph, g: CSRGraph, affected: np.ndarray,
                  plan_cap, plan_hot_cap):
    """Splice the affected rows of the patched CSR ``g`` into this rank's
    sharded layout ``sg`` (out of place, as :func:`patch_padded`).

    Each rank holds the whole host CSR, so every rank decides the same
    relayout and the same invalidated shards. Returns ``(new_sg, relayout,
    invalidated_shards, hot_rows_updated)``; ``invalidated_shards`` are the
    shards whose row block changed (all of them on a relayout)."""
    aff = np.asarray(affected, np.int64)
    if not aff.size:
        return sg, False, np.zeros(0, np.int64), 0
    hot_ids_h = sg.hot_ids.cpu().numpy()
    real_hot = hot_ids_h.size > 0 and int(hot_ids_h[0]) != PAD_ID

    def hot_pos_of(vs):
        if not real_hot:
            return np.full(len(vs), -1, np.int64)
        pos = np.minimum(np.searchsorted(hot_ids_h, vs), len(hot_ids_h) - 1)
        return np.where(hot_ids_h[pos] == vs, pos, -1)

    was_hot = hot_pos_of(aff) >= 0
    if _needs_relayout(g, aff, was_hot, sg.cap, sg.hot_cap,
                       plan_cap, plan_hot_cap):
        return ShardedGraph.from_csr(
            g, sg.num_shards, cap=plan_cap, hot_cap=plan_hot_cap,
            rank=sg.rank, device=sg.device), \
            True, np.arange(sg.num_shards, dtype=np.int64), 0

    deg_new = g.deg
    lo = sg.rank * sg.n_local
    mine = aff[(aff >= lo) & (aff < lo + sg.n_local)]
    new = sg
    if mine.size:
        rows_adj, rows_wgt = _pack_rows(g, mine, sg.cap)
        ap, ai = build_alias_rows(rows_wgt)
        rows = torch.from_numpy(mine - lo).to(sg.device)
        new = dataclasses.replace(
            sg,
            adj=_spliced(sg.adj, rows, rows_adj),
            wgt=_spliced(sg.wgt, rows, rows_wgt),
            alias_p=_spliced(sg.alias_p, rows, ap),
            alias_i=_spliced(sg.alias_i, rows, ai),
            deg=_spliced(sg.deg, rows, deg_new[mine]))

    hot_vs = aff[was_hot]
    if hot_vs.size:
        h_adj, h_wgt = _pack_rows(g, hot_vs, sg.hot_cap)
        h_ap, h_ai = build_alias_rows(h_wgt)
        h_min, h_max = _masked_min_max(h_adj, h_wgt, deg_new[hot_vs])
        hrows = torch.from_numpy(hot_pos_of(hot_vs)).to(sg.device)
        new = dataclasses.replace(
            new,
            hot_adj=_spliced(sg.hot_adj, hrows, h_adj),
            hot_wgt=_spliced(sg.hot_wgt, hrows, h_wgt),
            hot_alias_p=_spliced(sg.hot_alias_p, hrows, h_ap),
            hot_alias_i=_spliced(sg.hot_alias_i, hrows, h_ai),
            hot_deg=_spliced(sg.hot_deg, hrows, deg_new[hot_vs]),
            hot_wmin=_spliced(sg.hot_wmin, hrows, h_min),
            hot_wmax=_spliced(sg.hot_wmax, hrows, h_max))
    elif not real_hot and (g.n - 1) in aff:
        # the no-hot sentinel's scalars copy row n-1 (see
        # ``sharded_arrays``); kept in step so a patched layout equals a
        # fresh one. They are never sampled
        lo_e = int(g.row_ptr[g.n - 1])
        d = min(int(g.row_ptr[g.n] - lo_e), sg.cap)
        w = g.wgt[lo_e:lo_e + d]
        wmin, wmax = (float(w.min()), float(w.max())) if d else (1.0, 1.0)
        new = dataclasses.replace(
            new,
            hot_deg=torch.tensor(deg_new[g.n - 1:g.n], device=sg.device),
            hot_wmin=torch.full((1,), wmin, device=sg.device),
            hot_wmax=torch.full((1,), wmax, device=sg.device))

    invalidated = np.unique(aff // sg.n_local)
    return new, False, invalidated, int(hot_vs.size)
