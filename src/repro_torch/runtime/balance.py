"""Straggler and load-balance diagnostics of the range-partitioned walk —
port of ``repro.runtime.balance`` (numpy only).

In a bulk-synchronous superstep the slowest shard sets the pace. The
degree cap and hot cache bound each walker's exact work at O(cap), the
exchange capacity bounds any shard's serving load, and FN-Multi rounds
bound the rest; :func:`shard_balance` measures what imbalance is left.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.graph import CSRGraph


@dataclasses.dataclass
class BalanceReport:
    shards: int
    edges_per_shard: np.ndarray
    hot_per_shard: np.ndarray
    capped_work_per_shard: np.ndarray

    @property
    def edge_imbalance(self) -> float:
        m = self.edges_per_shard.mean()
        return float(self.edges_per_shard.max() / m) if m else 1.0

    @property
    def capped_imbalance(self) -> float:
        """Imbalance of the per-step work after the cap and the cache —
        what sets a superstep's time."""
        m = self.capped_work_per_shard.mean()
        return float(self.capped_work_per_shard.max() / m) if m else 1.0

    def to_dict(self) -> Dict:
        return {"shards": self.shards,
                "edge_imbalance": self.edge_imbalance,
                "capped_imbalance": self.capped_imbalance}


def shard_balance(g: CSRGraph, num_shards: int, cap: int) -> BalanceReport:
    """Range-partition diagnostics: raw edge imbalance vs post-cap work."""
    n_pad = ((g.n + num_shards - 1) // num_shards) * num_shards
    n_local = n_pad // num_shards
    deg = np.zeros(n_pad, np.int64)
    deg[:g.n] = g.deg
    per = deg.reshape(num_shards, n_local)
    return BalanceReport(shards=num_shards, edges_per_shard=per.sum(axis=1),
                         hot_per_shard=(per > cap).sum(axis=1),
                         capped_work_per_shard=np.minimum(per, cap).sum(
                             axis=1))
