"""Graph containers — port of ``repro.core.graph``.

* :class:`CSRGraph` — host-side numpy CSR graph with rows sorted ascending
  (membership during the second-order walk is a search in a sorted row).
* :class:`PaddedGraph` — the device layout: degree-capped padded adjacency
  (FN-Base when ``cap`` is the largest degree) plus a hot cache holding the
  full rows of every vertex whose degree exceeds ``cap`` (FN-Cache), with
  the first-order alias tables of both. Fields are torch tensors on one
  device.

Pads: neighbour ids are padded with ``PAD_ID`` (int32 max) so rows stay
sorted; weights are padded with 0 so padded lanes carry no probability.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.alias import build_alias_rows
from repro_torch.device import resolve_device
from repro_torch.tracing import stage

PAD_ID = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR graph with sorted neighbour lists."""

    n: int
    row_ptr: np.ndarray  # [n+1] int64
    col: np.ndarray      # [m]   int32, sorted within each row
    wgt: np.ndarray      # [m]   float32, > 0

    @property
    def m(self) -> int:
        return int(self.col.shape[0])

    @property
    def deg(self) -> np.ndarray:
        return (self.row_ptr[1:] - self.row_ptr[:-1]).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.deg.max()) if self.n else 0

    def neighbors(self, v: int) -> np.ndarray:
        return self.col[self.row_ptr[v]:self.row_ptr[v + 1]]

    def weights(self, v: int) -> np.ndarray:
        return self.wgt[self.row_ptr[v]:self.row_ptr[v + 1]]

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   wgt: Optional[np.ndarray] = None, undirected: bool = True,
                   dedup: bool = True) -> "CSRGraph":
        """Build a CSR graph from an edge list. Self loops are dropped,
        duplicates deduped (first weight wins); ``undirected`` adds the
        reverse edges before dedup."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if wgt is None:
            wgt = np.ones(src.shape[0], dtype=np.float32)
        wgt = np.asarray(wgt, dtype=np.float32)
        keep = src != dst
        src, dst, wgt = src[keep], dst[keep], wgt[keep]
        if undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            wgt = np.concatenate([wgt, wgt])
        order = np.lexsort((dst, src))
        src, dst, wgt = src[order], dst[order], wgt[order]
        if dedup and src.size:
            first = np.ones(src.shape[0], dtype=bool)
            first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
            src, dst, wgt = src[first], dst[first], wgt[first]
        counts = np.bincount(src, minlength=n).astype(np.int64)
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return CSRGraph(n=n, row_ptr=row_ptr, col=dst.astype(np.int32),
                        wgt=wgt.astype(np.float32))

    def trim_top_weights(self, k: int) -> "CSRGraph":
        """Spark-Node2Vec's trim: keep only the ``k`` highest-weight edges
        of each vertex (paper §2.2), the baseline of the classification
        example; the JAX package's choice of edges among tied weights."""
        keep_idx = []
        for v in range(self.n):
            lo, hi = self.row_ptr[v], self.row_ptr[v + 1]
            if hi - lo <= k:
                keep_idx.append(np.arange(lo, hi))
            else:
                top = np.argpartition(-self.wgt[lo:hi], k - 1)[:k]
                keep_idx.append(lo + np.sort(top))
        keep = np.concatenate(keep_idx) if keep_idx else \
            np.zeros(0, np.int64)
        src = np.repeat(np.arange(self.n, dtype=np.int64),
                        [len(ix) for ix in keep_idx])
        return CSRGraph.from_edges(self.n, src,
                                   self.col[keep].astype(np.int64),
                                   self.wgt[keep], undirected=False)


FIELDS = ("adj", "wgt", "deg", "alias_p", "alias_i", "w_min", "w_max",
          "hot_pos", "hot_ids", "hot_adj", "hot_wgt", "hot_alias_p",
          "hot_alias_i")


@dataclasses.dataclass
class PaddedGraph:
    """Device-side degree-capped adjacency + hot cache (tensors).

    Invariant: every vertex with ``deg > cap`` is hot. Hot vertices' cold
    rows hold only their first ``cap`` neighbours and are never read for
    sampling; exact reads for hot vertices go through the hot arrays.
    """

    n: int
    cap: int                    # cold row width
    hot_cap: int                # hot row width (>= max hot degree)
    adj: torch.Tensor           # [n, cap] int32, PAD_ID padded, sorted
    wgt: torch.Tensor           # [n, cap] float32, 0 padded
    deg: torch.Tensor           # [n] int32 true degree
    alias_p: torch.Tensor       # [n, cap] float32 first-order alias table
    alias_i: torch.Tensor       # [n, cap] int32 alias companion slot
    w_min: torch.Tensor         # [n] float32 (1.0 if isolated)
    w_max: torch.Tensor         # [n] float32
    hot_pos: torch.Tensor       # [n] int32 row in the hot arrays, -1 if cold
    hot_ids: torch.Tensor       # [K] int32 (row 0 a PAD_ID dummy if no hot)
    hot_adj: torch.Tensor       # [K, hot_cap] int32
    hot_wgt: torch.Tensor       # [K, hot_cap] float32
    hot_alias_p: torch.Tensor   # [K, hot_cap] float32
    hot_alias_i: torch.Tensor   # [K, hot_cap] int32

    @property
    def num_hot(self) -> int:
        return int(self.hot_ids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.adj.device

    @staticmethod
    def build(g: CSRGraph, cap: Optional[int] = None,
              hot_cap: Optional[int] = None, device=None) -> "PaddedGraph":
        """``cap=None`` -> cap = max degree (FN-Base layout: no hot set).
        ``device=None`` means the card; pass ``"cpu"`` for the host."""
        device = resolve_device(device)
        with stage("layout"):
            return PaddedGraph.from_numpy(
                layout_arrays(g, cap, hot_cap), g.n, device)

    @staticmethod
    def from_numpy(fields: dict, n: int, device) -> "PaddedGraph":
        """Wrap the numpy arrays of :func:`layout_arrays` (or of the JAX
        package's ``PaddedGraph``) as tensors on ``device``."""
        dtypes = {"adj": np.int32, "deg": np.int32, "alias_i": np.int32,
                  "hot_pos": np.int32, "hot_ids": np.int32,
                  "hot_adj": np.int32, "hot_alias_i": np.int32}
        t = {k: torch.tensor(np.asarray(
                 fields[k], dtype=dtypes.get(k, np.float32)), device=device)
             for k in FIELDS}
        return PaddedGraph(n=int(n), cap=int(t["adj"].shape[1]),
                           hot_cap=int(t["hot_adj"].shape[1]), **t)


def layout_arrays(g: CSRGraph, cap: Optional[int] = None,
                  hot_cap: Optional[int] = None) -> dict:
    """The FN-Base / FN-Cache layout of ``g`` as numpy arrays keyed by
    :data:`FIELDS` (the host half of ``PaddedGraph.build``)."""
    deg = g.deg
    max_deg = g.max_degree
    if cap is None or cap >= max(max_deg, 1):
        cap = max(max_deg, 1)
    cap = max(int(cap), 1)
    hot_vertices = np.nonzero(deg > cap)[0].astype(np.int32)
    if hot_cap is None:
        hot_cap = int(deg[hot_vertices].max()) if len(hot_vertices) else cap
    hot_cap = max(int(hot_cap), cap)

    def pack_rows(vertices: np.ndarray, width: int):
        rows = np.full((len(vertices), width), PAD_ID, dtype=np.int32)
        wrows = np.zeros((len(vertices), width), dtype=np.float32)
        for i, v in enumerate(vertices):
            lo, hi = g.row_ptr[v], g.row_ptr[v + 1]
            d = min(int(hi - lo), width)
            rows[i, :d] = g.col[lo:lo + d]
            wrows[i, :d] = g.wgt[lo:lo + d]
        return rows, wrows

    with stage("layout.rows"):
        adj, wgt = pack_rows(np.arange(g.n, dtype=np.int32), cap)
        if len(hot_vertices):
            hot_list = hot_vertices
            hot_adj, hot_wgt = pack_rows(hot_list, hot_cap)
        else:
            # sentinel hot set that can never match a real vertex id
            hot_list = np.full(1, PAD_ID, np.int32)
            hot_adj = np.full((1, hot_cap), PAD_ID, np.int32)
            hot_wgt = np.zeros((1, hot_cap), np.float32)

    hot_pos = np.full(g.n, -1, dtype=np.int32)
    hot_pos[hot_vertices] = np.arange(len(hot_vertices), dtype=np.int32)

    with stage("layout.alias"):
        alias_p, alias_i = build_alias_rows(wgt)
        hot_alias_p, hot_alias_i = build_alias_rows(hot_wgt)

    w_min = np.ones(g.n, dtype=np.float32)
    w_max = np.ones(g.n, dtype=np.float32)
    nz = deg > 0
    mask = adj != PAD_ID
    with np.errstate(invalid="ignore"):
        w_min[nz] = np.where(mask, wgt, np.inf).min(axis=1)[nz]
        w_max[nz] = np.where(mask, wgt, -np.inf).max(axis=1)[nz]
    if len(hot_vertices):
        # cold rows of hot vertices are truncated: take the full hot rows
        hmask = hot_adj != PAD_ID
        w_min[hot_vertices] = np.where(hmask, hot_wgt, np.inf).min(axis=1)
        w_max[hot_vertices] = np.where(hmask, hot_wgt, -np.inf).max(axis=1)

    return dict(adj=adj, wgt=wgt, deg=deg, alias_p=alias_p, alias_i=alias_i,
                w_min=w_min, w_max=w_max, hot_pos=hot_pos, hot_ids=hot_list,
                hot_adj=hot_adj, hot_wgt=hot_wgt, hot_alias_p=hot_alias_p,
                hot_alias_i=hot_alias_i)
