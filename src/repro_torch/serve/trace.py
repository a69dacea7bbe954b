"""Synthetic serving traffic — Zipf node popularity, Poisson-ish arrivals;
port of ``repro.serve.trace`` (the same events from the same seed).

Recommendation traffic is heavy-tailed in exactly the way the graphs are:
a few hub entities take most queries (the Tencent serving workload in
PAPERS.md). Under ``relabel=degree`` the graph's id order *is* degree order,
so drawing node ids from a Zipf over ``[0, n)`` makes query popularity track
vertex degree — the regime the FN-Cache-style admission policy is built for.

A trace is a list of :class:`TraceEvent` with relative arrival offsets; the
launcher (``repro_torch.launch.serve_graph``) replays it
against a real or virtual clock.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arriving query: ``kind`` in {"embed", "rank"}, arrival offset in
    seconds from trace start, and a relative deadline budget."""
    kind: str
    node: int
    t_arrival: float
    deadline_s: float


def zipf_nodes(n: int, num: int, alpha: float = 1.1,
               seed: int = 0) -> np.ndarray:
    """``num`` node ids in ``[0, n)``, Zipf(alpha)-distributed by rank.
    Explicit inverse-CDF over the truncated support (numpy's ``zipf``
    resamples an unbounded tail, which is slow and bias-prone when ``n`` is
    small)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pmf = ranks ** (-alpha)
    cdf = np.cumsum(pmf / pmf.sum())
    u = np.random.default_rng(seed).random(num)
    return np.searchsorted(cdf, u).astype(np.int64).clip(0, n - 1)


def synthetic_trace(n: int, num: int, alpha: float = 1.1,
                    rank_share: float = 0.5, qps: float = 10_000.0,
                    deadline_s: float = 0.05, seed: int = 0
                    ) -> List[TraceEvent]:
    """A Zipf query trace: ``num`` events over ``[0, num/qps)`` seconds,
    ``rank_share`` of them ``rank`` queries (the rest ``embed``), exponential
    inter-arrivals at mean rate ``qps``, one deadline budget for all."""
    rng = np.random.default_rng(seed + 1)
    nodes = zipf_nodes(n, num, alpha=alpha, seed=seed)
    gaps = rng.exponential(1.0 / qps, size=num)
    arrivals = np.cumsum(gaps) - gaps[0]
    kinds = np.where(rng.random(num) < rank_share, "rank", "embed")
    return [TraceEvent(kind=str(k), node=int(v), t_arrival=float(t),
                       deadline_s=deadline_s)
            for k, v, t in zip(kinds, nodes, arrivals)]
