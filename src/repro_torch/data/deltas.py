"""Versioned edge-delta batches and the shard-local CSR patch — port of
``repro.data.deltas`` (host numpy, the same arrays and dtypes).

The ingestion half of the incremental update path: a validated,
per-shard-sorted batch format (:class:`DeltaBatch`), the CSR patch that
applies one (:func:`apply_delta_csr` — in-place per-shard splice when the
edge count is conserved, shard-local rebuild otherwise, never a whole-graph
rebuild), and Zipf churn-stream generators (:func:`zipf_churn`,
:func:`weight_churn`). The device half — re-packing only the affected rows
of the resident layout — lives in ``repro_torch.engine.update``.

Semantics of one batch, applied atomically:

1. **Removals first**: each ``(u, v)`` in the remove list is deleted if
   present; removals of absent edges are counted (``removed_missing``) but
   are not errors — churn streams race with themselves.
2. **Upserts second**: each ``(u, v, w)`` in the add list *replaces* the
   weight of an existing edge or inserts a new one. An edge both removed
   and re-added in the same batch ends up present with the new weight.

Batches are **directed** internally; :meth:`DeltaBatch.build` symmetrizes
undirected input (the CSR convention everywhere else in the repo), drops
self loops, dedups (last occurrence wins — the freshest event), and sorts
by ``(src, dst)``, which is *per-shard sorted* for any range partition of
vertex ids — the property the per-shard patch kernel relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.graph import CSRGraph

DELTA_FORMAT_VERSION = 1


def _as_ids(x) -> np.ndarray:
    a = np.atleast_1d(np.asarray(x, np.int64))
    if a.ndim != 1:
        raise ValueError(f"edge endpoint arrays must be 1-D, got {a.shape}")
    return a


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One validated, normalized batch of edge additions/removals.

    All arrays are sorted by ``(src, dst)`` and duplicate-free; adds carry
    per-edge weights. ``base_version`` optionally pins the batch to the
    :class:`~repro_torch.data.store.GraphStore` version it was generated
    against — ``GraphStore.apply`` rejects the batch if the store has moved
    on.
    """
    add_src: np.ndarray                  # [A] int64
    add_dst: np.ndarray                  # [A] int64
    add_wgt: np.ndarray                  # [A] float32, > 0
    rem_src: np.ndarray                  # [R] int64
    rem_dst: np.ndarray                  # [R] int64
    base_version: Optional[int] = None

    @property
    def num_add(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_remove(self) -> int:
        return int(self.rem_src.shape[0])

    @property
    def num_edges(self) -> int:
        """Total directed delta edges carried by the batch."""
        return self.num_add + self.num_remove

    @staticmethod
    def build(add: Optional[Tuple] = None, remove: Optional[Tuple] = None,
              undirected: bool = True,
              base_version: Optional[int] = None) -> "DeltaBatch":
        """Normalize raw edge lists into a :class:`DeltaBatch`.

        ``add`` is ``(src, dst)`` or ``(src, dst, wgt)`` (default weight
        1.0); ``remove`` is ``(src, dst)``. Self loops are dropped;
        ``undirected`` (default, matching the CSR constructors) adds reverse
        edges before dedup; on duplicate ``(u, v)`` the **last** occurrence
        wins (the freshest churn event).
        """
        def norm(pair, with_w):
            if pair is None:
                s = np.zeros(0, np.int64)
                return (s, s.copy(), np.zeros(0, np.float32)) if with_w \
                    else (s, s.copy())
            if with_w and len(pair) == 3:
                s, d, w = pair
                w = np.broadcast_to(
                    np.asarray(w, np.float32), _as_ids(s).shape).copy()
            else:
                s, d = pair[0], pair[1]
                w = None
            s, d = _as_ids(s), _as_ids(d)
            if s.shape != d.shape:
                raise ValueError(
                    f"src/dst length mismatch: {s.shape} vs {d.shape}")
            if with_w:
                if w is None:
                    w = np.ones(s.shape[0], np.float32)
                return s, d, w
            return s, d

        a_s, a_d, a_w = norm(add, with_w=True)
        r_s, r_d = norm(remove, with_w=False)
        if a_w.size and not (np.isfinite(a_w).all() and (a_w > 0).all()):
            raise ValueError("edge weights must be finite and > 0")

        keep = a_s != a_d
        a_s, a_d, a_w = a_s[keep], a_d[keep], a_w[keep]
        keep = r_s != r_d
        r_s, r_d = r_s[keep], r_d[keep]
        if undirected:
            a_s, a_d = np.concatenate([a_s, a_d]), np.concatenate([a_d, a_s])
            a_w = np.concatenate([a_w, a_w])
            r_s, r_d = np.concatenate([r_s, r_d]), np.concatenate([r_d, r_s])

        def sort_dedup(s, d, w=None):
            order = np.lexsort((d, s))
            s, d = s[order], d[order]
            if w is not None:
                w = w[order]
            if s.size:
                # keep the LAST duplicate (stable lexsort preserves arrival
                # order within equal keys)
                last = np.ones(s.shape[0], bool)
                last[:-1] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
                s, d = s[last], d[last]
                if w is not None:
                    w = w[last]
            return (s, d, w) if w is not None else (s, d)

        a_s, a_d, a_w = sort_dedup(a_s, a_d, a_w)
        r_s, r_d = sort_dedup(r_s, r_d)
        return DeltaBatch(add_src=a_s, add_dst=a_d, add_wgt=a_w,
                          rem_src=r_s, rem_dst=r_d,
                          base_version=base_version)

    def check(self, n: int) -> None:
        """Validate endpoints against a graph of ``n`` vertices. Deltas are
        edge-only: they never grow the vertex set."""
        for name, a in (("add_src", self.add_src), ("add_dst", self.add_dst),
                        ("rem_src", self.rem_src), ("rem_dst", self.rem_dst)):
            if a.size and (int(a.min()) < 0 or int(a.max()) >= n):
                bad = int(a[(a < 0) | (a >= n)][0])
                raise ValueError(
                    f"{name} contains vertex id {bad} outside [0, {n})")

    def remap(self, perm: np.ndarray) -> "DeltaBatch":
        """Map endpoint ids through ``perm[old_id] == new_id`` (the
        ``relabel=degree`` permutation frozen at ``open_graph`` time).

        Re-sorts after mapping: a permutation preserves dedup but not the
        ``(src, dst)`` order the per-shard patch kernel slices by."""
        p = np.asarray(perm, np.int64)
        a_s, a_d = p[self.add_src], p[self.add_dst]
        r_s, r_d = p[self.rem_src], p[self.rem_dst]
        ao = np.lexsort((a_d, a_s))
        ro = np.lexsort((r_d, r_s))
        return DeltaBatch(
            add_src=a_s[ao], add_dst=a_d[ao], add_wgt=self.add_wgt[ao],
            rem_src=r_s[ro], rem_dst=r_d[ro],
            base_version=self.base_version)


# --------------------------------------------------------------------------
# shard-local CSR patch
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PatchReport:
    """Accounting for one applied batch (or an aggregate of several).

    ``affected`` / ``affected_shards`` identify exactly the rows and
    range-partition shards whose adjacency changed — the engine's device
    invalidation is driven off these. ``in_place`` reports whether the
    splice reused the existing ``col``/``wgt`` arrays (possible when every
    affected shard's edge count is conserved and the arrays are writable).
    """
    num_shards: int
    n_local: int
    affected: np.ndarray           # [A] int64, sorted unique vertex ids
    affected_shards: np.ndarray    # [S_a] int64, sorted unique shard ids
    edges_added: int
    edges_removed: int
    edges_updated: int
    removed_missing: int
    in_place: bool
    m_before: int
    m_after: int

    @property
    def num_affected(self) -> int:
        return int(self.affected.shape[0])

    @property
    def delta_edges(self) -> int:
        return self.edges_added + self.edges_removed + self.edges_updated

    @property
    def shard_fraction(self) -> float:
        """Fraction of range-partition shards invalidated by the batch."""
        return len(self.affected_shards) / max(self.num_shards, 1)

    def merge(self, other: "PatchReport") -> "PatchReport":
        """Aggregate sequentially applied reports (same partition)."""
        return PatchReport(
            num_shards=self.num_shards, n_local=self.n_local,
            affected=np.union1d(self.affected, other.affected),
            affected_shards=np.union1d(self.affected_shards,
                                       other.affected_shards),
            edges_added=self.edges_added + other.edges_added,
            edges_removed=self.edges_removed + other.edges_removed,
            edges_updated=self.edges_updated + other.edges_updated,
            removed_missing=self.removed_missing + other.removed_missing,
            in_place=self.in_place and other.in_place,
            m_before=self.m_before, m_after=other.m_after)


def _patch_segment(g: CSRGraph, lo_v: int, hi_v: int,
                   rem_s, rem_d, add_s, add_d, add_w):
    """Recompute one shard's CSR segment under its slice of the batch.

    Works on the globally sorted key ``row * n + col`` (rows are sorted
    ascending in CSR, so the segment key is sorted): removals and upsert
    lookups are vectorized ``searchsorted`` probes, inserts are a merge.
    Returns (col, wgt, per-row lens, removed, missing, updated, added).
    """
    n = g.n
    lo_e, hi_e = int(g.row_ptr[lo_v]), int(g.row_ptr[hi_v])
    seg_col = np.asarray(g.col[lo_e:hi_e], np.int64)
    seg_wgt = np.array(g.wgt[lo_e:hi_e], np.float32)   # copy: weights mutate
    lens = (np.asarray(g.row_ptr[lo_v + 1:hi_v + 1])
            - np.asarray(g.row_ptr[lo_v:hi_v]))
    rid = np.repeat(np.arange(lo_v, hi_v, dtype=np.int64), lens)
    key = rid * n + seg_col

    def probe(qkey):
        if not key.size:
            return np.zeros(qkey.shape[0], np.int64), \
                np.zeros(qkey.shape[0], bool)
        pos = np.searchsorted(key, qkey)
        safe = np.minimum(pos, key.shape[0] - 1)
        return safe, (pos < key.shape[0]) & (key[safe] == qkey)

    keep = np.ones(key.shape[0], bool)
    removed = missing = 0
    if rem_s.size:
        pos, found = probe(rem_s * n + rem_d)
        keep[pos[found]] = False
        removed, missing = int(found.sum()), int((~found).sum())

    updated = added = 0
    ins_key = np.zeros(0, np.int64)
    ins_w = np.zeros(0, np.float32)
    if add_s.size:
        akey = add_s * n + add_d
        pos, exists = probe(akey)
        upd = exists & keep[pos]           # removed-and-re-added -> insert
        seg_wgt[pos[upd]] = add_w[upd]
        updated = int(upd.sum())
        ins = ~upd
        ins_key, ins_w = akey[ins], add_w[ins]
        added = int(ins.sum())

    new_key = np.concatenate([key[keep], ins_key])
    new_w = np.concatenate([seg_wgt[keep], ins_w])
    order = np.argsort(new_key, kind="stable")
    new_key, new_w = new_key[order], new_w[order]
    new_lens = np.bincount(new_key // n - lo_v,
                           minlength=hi_v - lo_v).astype(np.int64)
    return (new_key % n).astype(np.int32), new_w, new_lens, \
        removed, missing, updated, added


def apply_delta_csr(g: CSRGraph, batch: DeltaBatch, num_shards: int = 64,
                    allow_in_place: bool = True
                    ) -> Tuple[CSRGraph, PatchReport]:
    """Apply one :class:`DeltaBatch` to a host CSR graph, shard-locally.

    The vertex range is partitioned into ``num_shards`` contiguous shards
    (``shard(v) = v // ceil(n / num_shards)`` — the same range partition
    ``ShardedGraph`` uses). Only shards containing a delta endpoint's *row*
    are recomputed; every other shard's segment is untouched (in-place) or
    copied wholesale (rebuild). When every affected shard conserves its edge
    count (pure weight updates, or adds balancing removals per shard) and
    the arrays are writable (not read-only memmaps), the patch splices in
    place with zero reallocation; otherwise new ``col``/``wgt`` arrays are
    allocated and unaffected segments are block-copied — never a whole-graph
    re-sort.
    """
    batch.check(g.n)
    n = g.n
    num_shards = max(1, min(int(num_shards), max(n, 1)))
    n_local = -(-n // num_shards) if n else 1
    affected = np.unique(np.concatenate([batch.add_src, batch.rem_src]))
    shards = np.unique(affected // n_local).astype(np.int64)
    m_before = g.m
    if not affected.size:
        report = PatchReport(
            num_shards=num_shards, n_local=n_local, affected=affected,
            affected_shards=shards, edges_added=0, edges_removed=0,
            edges_updated=0, removed_missing=0, in_place=True,
            m_before=m_before, m_after=m_before)
        return g, report

    def shard_slice(arr_s, arr_d, lo_v, hi_v, *extra):
        lo = np.searchsorted(arr_s, lo_v, side="left")
        hi = np.searchsorted(arr_s, hi_v, side="left")
        out = [arr_s[lo:hi], arr_d[lo:hi]]
        out.extend(e[lo:hi] for e in extra)
        return out

    patched = {}
    removed = missing = updated = added = 0
    conserved = True
    for s in shards.tolist():
        lo_v, hi_v = s * n_local, min((s + 1) * n_local, n)
        r_s, r_d = shard_slice(batch.rem_src, batch.rem_dst, lo_v, hi_v)
        a_s, a_d, a_w = shard_slice(batch.add_src, batch.add_dst, lo_v, hi_v,
                                    batch.add_wgt)
        col_s, wgt_s, lens_s, rm, ms, up, ad = _patch_segment(
            g, lo_v, hi_v, r_s, r_d, a_s, a_d, a_w)
        patched[s] = (lo_v, hi_v, col_s, wgt_s, lens_s)
        removed += rm
        missing += ms
        updated += up
        added += ad
        old_len = int(g.row_ptr[hi_v] - g.row_ptr[lo_v])
        conserved = conserved and col_s.shape[0] == old_len

    writable = (getattr(g.col, "flags", None) is not None
                and g.col.flags.writeable and g.wgt.flags.writeable
                and g.row_ptr.flags.writeable)
    in_place = allow_in_place and conserved and writable
    if in_place:
        for lo_v, hi_v, col_s, wgt_s, lens_s in patched.values():
            lo_e = int(g.row_ptr[lo_v])
            g.col[lo_e:lo_e + col_s.shape[0]] = col_s
            g.wgt[lo_e:lo_e + wgt_s.shape[0]] = wgt_s
            # only intra-shard row boundaries move; shard ends are conserved
            g.row_ptr[lo_v + 1:hi_v] = lo_e + np.cumsum(lens_s)[:-1]
        out = g
        m_after = m_before
    else:
        lens_all = (np.asarray(g.row_ptr[1:])
                    - np.asarray(g.row_ptr[:-1])).astype(np.int64)
        for lo_v, hi_v, _, _, lens_s in patched.values():
            lens_all[lo_v:hi_v] = lens_s
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens_all, out=row_ptr[1:])
        m_after = int(row_ptr[-1])
        col = np.empty(m_after, np.int32)
        wgt = np.empty(m_after, np.float32)
        for s in range(num_shards):
            lo_v, hi_v = s * n_local, min((s + 1) * n_local, n)
            if hi_v <= lo_v:
                break
            dst_lo = int(row_ptr[lo_v])
            if s in patched:
                _, _, col_s, wgt_s, _ = patched[s]
                col[dst_lo:dst_lo + col_s.shape[0]] = col_s
                wgt[dst_lo:dst_lo + wgt_s.shape[0]] = wgt_s
            else:                           # block copy, no per-row work
                src_lo, src_hi = int(g.row_ptr[lo_v]), int(g.row_ptr[hi_v])
                col[dst_lo:dst_lo + (src_hi - src_lo)] = g.col[src_lo:src_hi]
                wgt[dst_lo:dst_lo + (src_hi - src_lo)] = g.wgt[src_lo:src_hi]
        out = CSRGraph(n=n, row_ptr=row_ptr, col=col, wgt=wgt)

    report = PatchReport(
        num_shards=num_shards, n_local=n_local, affected=affected,
        affected_shards=shards, edges_added=added, edges_removed=removed,
        edges_updated=updated, removed_missing=missing, in_place=in_place,
        m_before=m_before, m_after=m_after)
    return out, report


# --------------------------------------------------------------------------
# Zipf churn stream (bench/test workload)
# --------------------------------------------------------------------------

def weight_churn(g: CSRGraph, num_batches: int, batch_edges: int,
                 alpha: float = 1.0, seed: int = 0,
                 top: Optional[int] = None) -> Iterator[DeltaBatch]:
    """Weight-only churn: re-weight existing edges whose endpoints both sit
    in the ``top`` highest-degree vertices (Zipf(``alpha``) over the source's
    degree rank). Degrees never change, so these batches always take the
    no-relayout device path and the in-place CSR splice — the steady-state
    "interaction intensities drift" workload the update benchmark gates."""
    rng = np.random.default_rng(seed)
    rank = np.argsort(-g.deg.astype(np.int64), kind="stable")  # rank -> id
    k_cand = g.n if top is None else max(2, min(int(top), g.n))
    cand = rank[:k_cand]
    in_cand = np.zeros(g.n, bool)
    in_cand[cand] = True
    src_rank = np.full(g.n, k_cand, np.int64)
    src_rank[cand] = np.arange(k_cand)

    lens = (np.asarray(g.row_ptr[1:]) - np.asarray(g.row_ptr[:-1]))
    rid = np.repeat(np.arange(g.n, dtype=np.int64), lens)
    col = np.asarray(g.col, np.int64)
    live = (rid < col) & in_cand[rid] & in_cand[col]   # each edge once
    e_src, e_dst = rid[live], col[live]
    if not e_src.size:
        raise ValueError(f"no edges with both endpoints in the top {k_cand}")
    probs = 1.0 / (src_rank[e_src] + 1).astype(np.float64) ** alpha
    probs /= probs.sum()

    for _ in range(num_batches):
        k = min(batch_edges, e_src.shape[0])
        idx = rng.choice(e_src.shape[0], size=k, replace=False, p=probs)
        w = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
        yield DeltaBatch.build(add=(e_src[idx], e_dst[idx], w))


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique`` by sorting (numpy 2.3's hashing ``unique`` takes ~50x
    longer on millions of int64 keys)."""
    keys = np.sort(keys)
    if not keys.size:
        return keys
    return keys[np.concatenate([[True], keys[1:] != keys[:-1]])]


def _has(sorted_keys: np.ndarray, key: int) -> bool:
    i = int(np.searchsorted(sorted_keys, key))
    return i < sorted_keys.shape[0] and int(sorted_keys[i]) == key


def zipf_churn(g: CSRGraph, num_batches: int, batch_edges: int,
               alpha: float = 1.0, seed: int = 0,
               add_fraction: float = 0.5,
               weight_updates: bool = True,
               top: Optional[int] = None) -> Iterator[DeltaBatch]:
    """Generate ``num_batches`` valid churn batches against ``g``.

    Endpoints are drawn Zipf(``alpha``) over *degree rank* — under
    ``relabel=degree`` that is Zipf over vertex id, so churn concentrates on
    the low-id shards exactly like serving traffic does. ``top`` truncates
    the candidate set to the ``top`` highest-degree vertices (both endpoints
    of every event), which bounds the set of shards a batch can touch — the
    update benchmark uses this to pin the invalidated-shard fraction. Each
    batch holds ``batch_edges`` undirected events split between additions
    (new edges or, with ``weight_updates``, weight bumps on existing ones)
    and removals of currently-present edges between candidate vertices; the
    stream tracks its own edits so removals target live edges and re-adds
    are well defined.
    """
    rng = np.random.default_rng(seed)
    rank = np.argsort(-g.deg.astype(np.int64), kind="stable")  # rank -> id
    k_cand = g.n if top is None else max(2, min(int(top), g.n))
    cand = rank[:k_cand]
    in_cand = np.zeros(g.n, bool)
    in_cand[cand] = True
    probs = 1.0 / np.arange(1, k_cand + 1, dtype=np.float64) ** alpha
    probs /= probs.sum()

    # live edges with BOTH endpoints in the candidate set — the removal
    # pool — as sorted keys u * n + v (u < v), whose order is that of the
    # reference's sorted (u, v) tuples; the same draws from ``rng`` in the
    # same order, without a Python loop over every edge
    n = g.n
    lens = np.asarray(g.row_ptr[1:]) - np.asarray(g.row_ptr[:-1])
    rid = np.repeat(np.arange(n, dtype=np.int64), lens)
    col = np.asarray(g.col, np.int64)
    keep = (rid < col) & in_cand[rid] & in_cand[col]
    live = _sorted_unique(rid[keep] * n + col[keep])

    def draw(k):
        return cand[rng.choice(k_cand, size=k, p=probs)]

    for _ in range(num_batches):
        n_add = int(round(batch_edges * add_fraction))
        n_rem = batch_edges - n_add
        adds = []
        added = set()                  # keys this batch added to ``live``
        while len(adds) < n_add:
            us, vs = draw(n_add), draw(n_add)
            for u, v in zip(us.tolist(), vs.tolist()):
                if u == v or len(adds) >= n_add:
                    continue
                e = min(u, v) * n + max(u, v)
                if not weight_updates and (e in added or _has(live, e)):
                    continue
                adds.append((u, v, float(rng.uniform(0.5, 2.0))))
                added.add(e)
        if added:
            live = _sorted_unique(np.concatenate(
                [live, np.fromiter(added, np.int64)]))
        rems = np.zeros((0, 2), np.int64)
        if live.size and n_rem:
            idx = rng.permutation(live.shape[0])[:n_rem]
            rems = np.stack([live[idx] // n, live[idx] % n], axis=1)
            live = np.delete(live, idx)
        add_arr = np.asarray(adds, np.float64).reshape(-1, 3)
        rem_arr = rems.reshape(-1, 2)
        yield DeltaBatch.build(
            add=(add_arr[:, 0].astype(np.int64),
                 add_arr[:, 1].astype(np.int64),
                 add_arr[:, 2].astype(np.float32)),
            remove=(rem_arr[:, 0], rem_arr[:, 1]))
