"""Distributed Fast-Node2Vec walk over a ``torch.distributed`` world — the
``"sharded"`` backend of ``WalkEngine``, port of
``repro.core.walk_distributed``.

Pregel on P ranks (DESIGN.md §2), one program per rank:

* The graph is **range-partitioned** by vertex id: rank ``r`` holds rows
  ``[r·n_local, (r+1)·n_local)`` (:class:`ShardedGraph`) plus the
  replicated hot cache. Walkers live on the rank of their start vertex,
  so the paper's STEP messages are local writes.
* One **superstep** is one pass of a Python loop; the NEIG message is a
  two-phase pull through ``dist.all_to_all_single`` — request ids out,
  neighbour rows back — where JAX's ``shard_map`` runs ``all_to_all``.
  FN-Local: requests for local rows never enter the buffers. FN-Cache:
  hot rows are replicated, so the payload is the cold width. FN-Approx:
  the O(1) alias draw at hot vertices, from the replicated tables.
* The sampling math is ``repro_torch.engine.sampler``'s, shared with the
  single-device backends, and RNG keys are ``fold_in(fold_in(seed,
  walker), step)``, so the walks equal the reference backend's integer for
  integer, and the JAX package's.

Capacity: each exchange has ``capacity`` request slots per destination;
requests past it are dropped (the walker stays put for that step) and
counted. Pipelined mode (``WalkPlan.pipeline``, DESIGN.md §12) splits each
rank's walkers into cohorts A (the first ceil(W/2)) and B and issues one
cohort's row exchange with ``async_op=True`` before the other cohort's
sampling; the walks are the barrier body's.

Where JAX's gathers clamp an index, these clamp it explicitly: torch
indexing raises where XLA clamps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.core.alias import alias_sample, build_alias_rows
from repro_torch.core.graph import PAD_ID, CSRGraph, PaddedGraph
from repro_torch.device import resolve_device
from repro_torch.engine.sampler import HotContext, Sampler

ROW_FIELDS = ("adj", "wgt", "alias_p", "alias_i", "deg")
HOT_FIELDS = ("hot_ids", "hot_adj", "hot_wgt", "hot_alias_p",
              "hot_alias_i", "hot_deg", "hot_wmin", "hot_wmax")
_INT_FIELDS = ("adj", "alias_i", "deg", "hot_ids", "hot_adj", "hot_alias_i",
               "hot_deg")


@dataclasses.dataclass
class ShardedGraph:
    """One rank's part of the range-partitioned layout: its row block
    (``adj``, ``wgt``, ``alias_p``, ``alias_i`` [n_local, cap], ``deg``
    [n_local]) and the replicated hot pack (``hot_*``, K rows sorted by
    id; a single ``PAD_ID`` sentinel row without a hot set)."""
    n: int            # padded vertex count (a multiple of num_shards)
    n_orig: int
    num_shards: int
    rank: int
    cap: int
    hot_cap: int
    adj: torch.Tensor
    wgt: torch.Tensor
    alias_p: torch.Tensor
    alias_i: torch.Tensor
    deg: torch.Tensor
    hot_ids: torch.Tensor
    hot_adj: torch.Tensor
    hot_wgt: torch.Tensor
    hot_alias_p: torch.Tensor
    hot_alias_i: torch.Tensor
    hot_deg: torch.Tensor
    hot_wmin: torch.Tensor
    hot_wmax: torch.Tensor

    @property
    def n_local(self) -> int:
        return self.n // self.num_shards

    @property
    def device(self) -> torch.device:
        return self.adj.device

    @staticmethod
    def from_csr(g: CSRGraph, num_shards: int, cap: Optional[int] = None,
                 hot_cap: Optional[int] = None, rank: int = 0,
                 device=None) -> "ShardedGraph":
        """Rank ``rank``'s layout straight from the host CSR: only its own
        rows are packed (no whole-graph ``PaddedGraph``). ``device=None``
        is the card, as every entry point (``"cpu"`` by name)."""
        device = resolve_device(device)
        arrays = sharded_arrays(g, num_shards, cap, hot_cap, rank=rank)
        t = {k: torch.from_numpy(np.ascontiguousarray(
                 arrays[k], np.int32 if k in _INT_FIELDS else np.float32))
             .to(device) for k in ROW_FIELDS + HOT_FIELDS}
        return ShardedGraph(n=arrays["n"], n_orig=arrays["n_orig"],
                            num_shards=num_shards, rank=rank,
                            cap=arrays["cap"], hot_cap=arrays["hot_cap"],
                            **t)

    @staticmethod
    def build(pg: PaddedGraph, num_shards: int,
              rank: int = 0) -> "ShardedGraph":
        """Rank ``rank``'s layout from a ``PaddedGraph`` on its device:
        rows padded to the shard multiple (adj ``PAD_ID``, weights 0,
        alias_p 1, alias_i 0, deg 0) and the hot scalars gathered at
        ``hot_ids`` (the sentinel reads row n-1, as JAX's clamped
        gather)."""
        n_pad = ((pg.n + num_shards - 1) // num_shards) * num_shards
        n_local = n_pad // num_shards
        lo, hi = rank * n_local, min((rank + 1) * n_local, pg.n)

        def block(x, fill):
            rows = x[lo:hi]
            if hi - lo == n_local:
                return rows
            pad = x.new_full((n_local - (hi - lo),) + x.shape[1:], fill)
            return torch.cat([rows, pad])

        hid = pg.hot_ids.long().clamp(0, pg.n - 1)
        return ShardedGraph(
            n=n_pad, n_orig=pg.n, num_shards=num_shards, rank=rank,
            cap=pg.cap, hot_cap=pg.hot_cap,
            adj=block(pg.adj, PAD_ID), wgt=block(pg.wgt, 0.0),
            alias_p=block(pg.alias_p, 1.0), alias_i=block(pg.alias_i, 0),
            deg=block(pg.deg, 0), hot_ids=pg.hot_ids, hot_adj=pg.hot_adj,
            hot_wgt=pg.hot_wgt, hot_alias_p=pg.hot_alias_p,
            hot_alias_i=pg.hot_alias_i, hot_deg=pg.deg[hid],
            hot_wmin=pg.w_min[hid], hot_wmax=pg.w_max[hid])


def _pack_block(g: CSRGraph, vertices, out_adj, out_wgt) -> None:
    width = out_adj.shape[1]
    for i, v in enumerate(vertices):
        lo, hi = g.row_ptr[v], g.row_ptr[v + 1]
        d = min(int(hi - lo), width)
        out_adj[i, :d] = g.col[lo:lo + d]
        out_wgt[i, :d] = g.wgt[lo:lo + d]


def sharded_arrays(g: CSRGraph, num_shards: int, cap: Optional[int] = None,
                   hot_cap: Optional[int] = None,
                   rank: Optional[int] = None) -> dict:
    """The host half of :meth:`ShardedGraph.from_csr`: numpy arrays of
    every shard's rows (``rank=None``, the global ``[n_pad, cap]`` arrays
    of the JAX package's ``ShardedGraph.from_csr``) or of one rank's
    block, the replicated hot pack, and the sizes."""
    deg = g.deg
    max_deg = g.max_degree
    if cap is None or cap >= max(max_deg, 1):
        cap = max(max_deg, 1)
    cap = max(int(cap), 1)
    hot_vertices = np.nonzero(deg > cap)[0].astype(np.int32)
    if hot_cap is None:
        hot_cap = int(deg[hot_vertices].max()) if len(hot_vertices) else cap
    hot_cap = max(int(hot_cap), cap)
    n = g.n
    n_pad = ((n + num_shards - 1) // num_shards) * num_shards
    n_local = n_pad // num_shards
    shards = range(num_shards) if rank is None else (rank,)
    rows = len(shards) * n_local
    adj = np.full((rows, cap), PAD_ID, np.int32)
    wgt = np.zeros((rows, cap), np.float32)
    alias_p = np.zeros((rows, cap), np.float32)
    alias_i = np.zeros((rows, cap), np.int32)
    deg_out = np.zeros(rows, np.int32)
    for j, s in enumerate(shards):
        o = j * n_local
        lo_v, hi_v = s * n_local, min((s + 1) * n_local, n)
        live = max(hi_v - lo_v, 0)
        alias_p[o + live:o + n_local] = 1.0     # padding rows
        if not live:
            continue
        _pack_block(g, range(lo_v, hi_v), adj[o:o + live], wgt[o:o + live])
        ap, ai = build_alias_rows(wgt[o:o + live])
        alias_p[o:o + live], alias_i[o:o + live] = ap, ai
        deg_out[o:o + live] = deg[lo_v:hi_v]

    def row_min_max(v, width):
        lo = g.row_ptr[v]
        d = min(int(g.row_ptr[v + 1] - lo), width)
        if d == 0:
            return 1.0, 1.0
        w = g.wgt[lo:lo + d]
        return float(w.min()), float(w.max())

    if len(hot_vertices):
        k = len(hot_vertices)
        hot_ids = hot_vertices
        hot_adj = np.full((k, hot_cap), PAD_ID, np.int32)
        hot_wgt = np.zeros((k, hot_cap), np.float32)
        _pack_block(g, hot_vertices, hot_adj, hot_wgt)
        hot_deg = deg[hot_vertices]
        mm = np.array([row_min_max(int(v), hot_cap) for v in hot_vertices],
                      np.float32)
        hot_wmin, hot_wmax = mm[:, 0], mm[:, 1]
    else:
        # the sentinel row; its scalars copy row n-1 (JAX's clamped
        # gathers at PAD_ID) and are never sampled
        hot_ids = np.full(1, PAD_ID, np.int32)
        hot_adj = np.full((1, hot_cap), PAD_ID, np.int32)
        hot_wgt = np.zeros((1, hot_cap), np.float32)
        hot_deg = deg[n - 1:n]
        wmin, wmax = row_min_max(n - 1, cap)
        hot_wmin = np.full(1, wmin, np.float32)
        hot_wmax = np.full(1, wmax, np.float32)
    hot_alias_p, hot_alias_i = build_alias_rows(hot_wgt)
    return dict(n=n_pad, n_orig=n, num_shards=num_shards, cap=cap,
                hot_cap=hot_cap, adj=adj, wgt=wgt, alias_p=alias_p,
                alias_i=alias_i, deg=deg_out, hot_ids=hot_ids,
                hot_adj=hot_adj, hot_wgt=hot_wgt, hot_alias_p=hot_alias_p,
                hot_alias_i=hot_alias_i, hot_deg=hot_deg, hot_wmin=hot_wmin,
                hot_wmax=hot_wmax)


def _hot_lookup(hot_ids: torch.Tensor, v: torch.Tensor):
    """Replicated hot-set membership: (is_hot, position in the pack)."""
    pos = torch.searchsorted(hot_ids, v.to(hot_ids.dtype)).clamp(
        max=hot_ids.shape[0] - 1)
    return hot_ids[pos] == v, pos


def _bucket_requests(dest: torch.Tensor, needs_remote: torch.Tensor,
                     v: torch.Tensor, num_shards: int, capacity: int):
    """Pack remote requests into per-destination slots of ``capacity``.

    Returns (buf [S*C] int32 request ids, slot of each walker [W] int64,
    -1 if it sends none, dropped mask [W]). Walkers rank by (destination,
    walker order), a stable sort. A slot past the buffer (a destination
    past the last shard) writes nothing, as JAX's scatter drops it."""
    w = dest.shape[0]
    sort_key = torch.where(needs_remote, dest.long(), num_shards)
    sorted_key, order = torch.sort(sort_key, stable=True)
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank_sorted = torch.arange(w, device=dest.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    ok = needs_remote & (rank < capacity)
    size = num_shards * capacity
    slot = torch.where(ok, dest.long() * capacity + rank, size)
    # every non-request writes the scratch lane ``size``, sliced off
    lane = torch.where((slot >= 0) & (slot <= size), slot, size)
    buf = torch.full((size + 1,), PAD_ID, dtype=torch.int32,
                     device=dest.device)
    buf.index_put_((lane,), v.to(torch.int32), accumulate=False)
    return buf[:size], torch.where(ok, slot, -1), needs_remote & ~ok


def _serve_requests(g: ShardedGraph, recv_ids: torch.Tensor, offset: int):
    """This rank's rows for incoming request ids [R]; PAD_ID -> a pad
    row."""
    local = (recv_ids.long() - offset).clamp(0, g.n_local - 1)
    valid = (recv_ids != PAD_ID)[:, None]
    return (torch.where(valid, g.adj[local], PAD_ID),
            torch.where(valid, g.wgt[local], 0.0))


def _widen(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    d = x.shape[-1]
    return x if d >= width else F.pad(x, (0, width - d), value=fill)


@dataclasses.dataclass
class Exchange:
    """One cohort's NEIG exchange in flight: the response buffers, the
    handles of their collectives (empty once complete), and each walker's
    slot and drop mask."""
    resp_i: torch.Tensor
    resp_w: torch.Tensor
    slot: torch.Tensor
    dropped: torch.Tensor
    works: list

    def wait(self) -> "Exchange":
        for work in self.works:
            work.wait()
        self.works = []
        return self


def _all_to_all(group, x: torch.Tensor, async_op: bool = False):
    """Block s of the result comes from rank s (equal splits): JAX's tiled
    ``all_to_all`` on axis 0. Returns (result, handle or None); without a
    group (a world of one) the identity."""
    if group is None:
        return x, None
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x.contiguous(), group=group,
                                  async_op=async_op)
    return out, work


def _issue_exchange(g: ShardedGraph, group, v: torch.Tensor, capacity: int,
                    async_op: bool = False) -> Exchange:
    """The communication half of a superstep for walkers at ``v``: bucket
    the remote requests, send the ids, serve the rows asked of this rank
    and send them back. With ``async_op`` the rows' exchange is left in
    flight (:meth:`Exchange.wait`)."""
    s, c = g.num_shards, capacity
    is_hot_v, _ = _hot_lookup(g.hot_ids, v)
    dest = torch.div(v, g.n_local, rounding_mode="floor")
    needs_remote = ~is_hot_v & (dest != g.rank)
    buf, slot, dropped = _bucket_requests(dest, needs_remote, v, s, c)
    recv, _ = _all_to_all(group, buf)
    rows_i, rows_w = _serve_requests(g, recv, g.rank * g.n_local)
    resp_i, wi = _all_to_all(group, rows_i, async_op)
    resp_w, ww = _all_to_all(group, rows_w, async_op)
    return Exchange(resp_i, resp_w, slot, dropped,
                    [w for w in (wi, ww) if w is not None])


def _finish_step(g: ShardedGraph, u, v, prev_ids, prev_deg, keys,
                 sampler: Sampler, ex: Exchange):
    """The compute half of a superstep: assemble each walker's candidate
    row (local, remote or hot) and draw the next vertex. Returns (next,
    carried cold row, deg_v, dropped)."""
    ex.wait()
    is_hot_v, hp = _hot_lookup(g.hot_ids, v)
    li = (v.long() - g.rank * g.n_local).clamp(0, g.n_local - 1)
    use_remote = (ex.slot >= 0)[:, None]
    safe = ex.slot.clamp(0, ex.resp_i.shape[0] - 1)
    cold_i = torch.where(use_remote, ex.resp_i[safe], g.adj[li])
    cold_w = torch.where(use_remote, ex.resp_w[safe], g.wgt[li])
    hot_v = is_hot_v[:, None]
    if sampler.mode == "approx_always":
        # hot vertices always take the O(1) alias path: candidates stay at
        # the cold width
        cand_i = _widen(cold_i, g.cap, PAD_ID)
        cand_w = _widen(cold_w, g.cap, 0.0)
    else:
        cand_i = torch.where(hot_v, g.hot_adj[hp],
                             _widen(cold_i, g.hot_cap, PAD_ID))
        cand_w = torch.where(hot_v, g.hot_wgt[hp],
                             _widen(cold_w, g.hot_cap, 0.0))

    # u's row for dist(u, x): carried if cold, from the cache if hot
    is_hot_u, hpu = _hot_lookup(g.hot_ids, u)
    prev_row = torch.where(is_hot_u[:, None], g.hot_adj[hpu],
                           _widen(prev_ids, g.hot_cap, PAD_ID))
    deg_u = torch.where(is_hot_u, g.hot_deg[hpu], prev_deg)
    hot = None
    if sampler.mode != "exact":
        hot = HotContext(
            is_hot_v=is_hot_v, is_hot_u=is_hot_u, deg_u=deg_u,
            deg_v=g.hot_deg[hp], w_min_v=g.hot_wmin[hp],
            w_max_v=g.hot_wmax[hp], alias_p=g.hot_alias_p[hp],
            alias_i=g.hot_alias_i[hp], alias_deg=g.hot_deg[hp])
    choice = sampler.choose(keys, cand_i, cand_w, u, prev_row, hot)
    if sampler.mode == "approx_always":
        nxt_hot = g.hot_adj[hp, choice.slot_alias]
        nxt_cold = torch.gather(cand_i, 1,
                                choice.slot_exact.long()[:, None])[:, 0]
        nxt = torch.where(choice.use_alias, nxt_hot, nxt_cold)
    else:
        nxt = torch.gather(cand_i, 1, choice.slot()[:, None])[:, 0]
    deg_v = (cand_w > 0).sum(dim=1).to(torch.int32)
    if sampler.mode == "approx_always":
        deg_v = torch.where(is_hot_v, g.hot_deg[hp], deg_v)
    alive = (deg_v > 0) & ~ex.dropped
    nxt = torch.where(alive, nxt, v)
    # the NEIG payload carried to the next step (cold width)
    new_prev = torch.where(hot_v, PAD_ID, cold_i)
    return nxt, new_prev, deg_v, ex.dropped


def _first_step_local(g: ShardedGraph, starts, keys):
    """Step 0: starts are local by construction; first-order alias draw.
    Returns (v1, the start rows, their degrees)."""
    li = (starts.long() - g.rank * g.n_local).clamp(0, g.n_local - 1)
    is_hot, hp = _hot_lookup(g.hot_ids, starts)
    hot = is_hot[:, None]
    ap = torch.where(hot, g.hot_alias_p[hp],
                     _widen(g.alias_p[li], g.hot_cap, 0.0))
    ai = torch.where(hot, g.hot_alias_i[hp],
                     _widen(g.alias_i[li], g.hot_cap, 0))
    ids = torch.where(hot, g.hot_adj[hp],
                      _widen(g.adj[li], g.hot_cap, PAD_ID))
    deg = g.deg[li]
    slots = alias_sample(keys, ap, ai, deg)
    nxt = torch.gather(ids, 1, slots[:, None])[:, 0]
    return torch.where(deg > 0, nxt, starts), g.adj[li], deg


def distributed_walk(g: ShardedGraph, group, sampler: Sampler,
                     capacity: int, length: int, starts: torch.Tensor,
                     walker_ids: torch.Tensor, seed_key: torch.Tensor,
                     pipeline: bool = False):
    """Walk this rank's walker block (``starts`` [Wl] int32, all owned by
    this rank) for ``length`` steps through exchanges on ``group``.
    Returns (walks [Wl, length] int32, this rank's dropped requests, a
    0-d int64 tensor). Every rank of the group calls it with blocks of
    one size, so their collectives pair up.

    ``pipeline`` issues cohort B's row exchange (``async_op=True``)
    before cohort A's sampling and A's next one before B's, and peels the
    last superstep so nothing is issued past the walk's end; the walks
    equal the barrier body's."""
    wkeys = jr.fold_in(seed_key, walker_ids.long())
    v1, prev_ids, prev_deg = _first_step_local(g, starts,
                                               jr.fold_in(wkeys, 0))
    drops = torch.zeros((), dtype=torch.int64, device=starts.device)
    if not pipeline or length < 2:
        cols, u, v = [v1], starts, v1
        for s in range(1, length):
            ex = _issue_exchange(g, group, v, capacity)
            nxt, prev_ids, prev_deg, dropped = _finish_step(
                g, u, v, prev_ids, prev_deg, jr.fold_in(wkeys, s), sampler,
                ex)
            drops = drops + dropped.sum()
            u, v = v, nxt
            cols.append(nxt)
        return torch.stack(cols, dim=1), drops

    wa = (starts.shape[0] + 1) // 2          # cohort A's size

    def cohort(rows):
        return dict(u=starts[rows], v=v1[rows], p=prev_ids[rows],
                    d=prev_deg[rows], k=wkeys[rows])
    a, b = cohort(slice(0, wa)), cohort(slice(wa, None))
    cols = [v1]

    def finish(c, s, ex):
        nonlocal drops
        nxt, c["p"], c["d"], dropped = _finish_step(
            g, c["u"], c["v"], c["p"], c["d"], jr.fold_in(c["k"], s),
            sampler, ex)
        drops = drops + dropped.sum()
        c["u"], c["v"] = c["v"], nxt

    # prologue: A's step-1 exchange, with nothing to hide behind
    ex_a = _issue_exchange(g, group, a["v"], capacity, async_op=True)
    for s in range(1, length - 1):
        ex_b = _issue_exchange(g, group, b["v"], capacity, async_op=True)
        finish(a, s, ex_a)
        ex_a = _issue_exchange(g, group, a["v"], capacity, async_op=True)
        finish(b, s, ex_b)
        cols.append(torch.cat([a["v"], b["v"]]))
    ex_b = _issue_exchange(g, group, b["v"], capacity, async_op=True)
    finish(a, length - 1, ex_a)
    finish(b, length - 1, ex_b)
    cols.append(torch.cat([a["v"], b["v"]]))
    return torch.stack(cols, dim=1), drops
