"""TrillionG-style RMAT graph generation (paper §4.1) — port of
``repro.core.rmat``, the same numpy code as the JAX package.

Generates the paper's three synthetic families:

* ``er(k)``      — (0.25, 0.25, 0.25, 0.25), avg degree 10 (ER-K graphs)
* ``wec(k)``     — (0.18, 0.25, 0.25, 0.32), avg degree ~100 (WeChat-like)
* ``skew(s, k)`` — b = c = 0.25, d = S*a, avg degree ~100 (Skew-S graphs)

Each edge draws one quadrant bit pair per level: P(row=1) = c+d, then
P(col=1 | row) per the conditional RMAT split — fully vectorized over
[num_edges, K] in numpy. Graphs are symmetrized and deduped by
``CSRGraph.from_edges`` like the paper's undirected treatment.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import CSRGraph


def rmat_edges(k: int, num_edges: int, a: float, b: float, c: float, d: float,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``num_edges`` directed RMAT edges over 2^k vertices."""
    assert abs(a + b + c + d - 1.0) < 1e-6
    rng = np.random.default_rng(seed)
    p_row1 = c + d
    p_col1_row0 = b / max(a + b, 1e-12)
    p_col1_row1 = d / max(c + d, 1e-12)
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(k):
        row = rng.random(num_edges) < p_row1
        p_col = np.where(row, p_col1_row1, p_col1_row0)
        col = rng.random(num_edges) < p_col
        src = (src << 1) | row
        dst = (dst << 1) | col
    return src, dst


def rmat_graph(k: int, avg_degree: float, a: float, b: float, c: float,
               d: float, seed: int = 0) -> CSRGraph:
    n = 1 << k
    # undirected symmetrization doubles edge endpoints; draw n*avg/2 edges
    num_edges = int(n * avg_degree / 2)
    src, dst = rmat_edges(k, num_edges, a, b, c, d, seed)
    return CSRGraph.from_edges(n, src, dst, undirected=True)


def er(k: int, avg_degree: float = 10.0, seed: int = 0) -> CSRGraph:
    """ER-K: uniform quadrants, no degree skew (paper Table 1)."""
    return rmat_graph(k, avg_degree, 0.25, 0.25, 0.25, 0.25, seed)


def wec(k: int, avg_degree: float = 100.0, seed: int = 0) -> CSRGraph:
    """WeC-K: WeChat-like social graph, (0.18, 0.25, 0.25, 0.32)."""
    return rmat_graph(k, avg_degree, 0.18, 0.25, 0.25, 0.32, seed)


def skew(s: float, k: int = 22, avg_degree: float = 100.0,
         seed: int = 0) -> CSRGraph:
    """Skew-S: b = c = 0.25, d = S*a, a + d = 0.5 (paper §4.1)."""
    a = 0.5 / (1.0 + s)
    d = s * a
    return rmat_graph(k, avg_degree, a, 0.25, 0.25, d, seed)


def sbm_labeled(n: int, num_communities: int, p_in: float, p_out: float,
                seed: int = 0) -> tuple[CSRGraph, np.ndarray]:
    """Stochastic-block-model labeled graph — stands in for BlogCatalog in the
    node-classification accuracy experiment (paper Fig. 6): vertices carry
    community labels; embeddings good enough to linearly separate communities
    score high micro/macro-F1."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_communities, size=n)
    # sample edges by expected count per pair class (sparse sampling)
    exp_in = int(p_in * n * (n / num_communities) / 2)
    exp_out = int(p_out * n * n / 2)
    si = rng.integers(0, n, size=exp_in * 2)
    di_base = rng.integers(0, n, size=exp_in * 2)
    same = labels[si] == labels[di_base]
    si, di = si[same][:exp_in], di_base[same][:exp_in]
    so = rng.integers(0, n, size=exp_out * 2)
    do = rng.integers(0, n, size=exp_out * 2)
    diff = labels[so] != labels[do]
    so, do = so[diff][:exp_out], do[diff][:exp_out]
    src = np.concatenate([si, so])
    dst = np.concatenate([di, do])
    return CSRGraph.from_edges(n, src, dst, undirected=True), labels
