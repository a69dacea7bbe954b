"""WalkEngine — port of the single-device half of
``repro.engine.engine`` (the ``reference`` and ``fused`` backends).

    engine = WalkEngine.build(graph, plan)          # on the card
    result = engine.run(starts=None, seed=0)        # WalkResult(walks, stats)
    for r in engine.rounds(10, seed=0): ...         # FN-Multi rounds

``build`` accepts what :func:`~repro_torch.data.store.open_graph` accepts
(a spec string, a CSRGraph, a Dataset, a GraphStore) or a prebuilt
:class:`PaddedGraph`. ``device=None`` means the card; the tests pass
``device="cpu"``. Walker ids default to the start vertex ids, so the same
plan and seed give the same walks on every backend and in the JAX package.

``engine.update(deltas)`` applies edge deltas through the engine's
GraphStore and splices only the affected rows into a new device layout
(``repro_torch.engine.update``); runs already enqueued keep the old one.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.graph import PaddedGraph
from repro_torch.core.walk import run_fused_persistent, run_reference
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.engine.plan import WalkPlan, WalkResult, WalkStats
from repro_torch.engine.update import UpdateReport, patch_padded


def round_seed(seed: int, r: int) -> int:
    """Per-round seed for FN-Multi rounds (as in the JAX package)."""
    return seed * 1000003 + r


class WalkEngine:
    """Executable walk workload: a plan bound to a device layout."""

    def __init__(self, plan: WalkPlan, pg: PaddedGraph, store=None):
        self.plan = plan
        self.pg = pg
        self.store = store              # GraphStore (update()'s source)
        self._sampler = plan.sampler()
        self._no_hot = int(pg.hot_pos.max()) < 0
        self._delta_edges = 0           # cumulative churn via update()
        self._last_invalidated_fraction = 0.0

    @classmethod
    def build(cls, graph, plan: WalkPlan, device=None) -> "WalkEngine":
        """Bind ``plan`` to ``graph`` on ``device`` (default: the card)."""
        if isinstance(graph, PaddedGraph):
            if device is not None and \
                    torch.device(device) != graph.device:
                raise ValueError(f"PaddedGraph lives on {graph.device}, "
                                 f"not {device}")
            return cls(plan, graph)
        device = resolve_device(device)
        store = open_graph(graph)
        pg = PaddedGraph.build(store.graph, cap=plan.cap,
                               hot_cap=plan.hot_cap, device=device)
        return cls(plan, pg, store)

    @property
    def n(self) -> int:
        return self.pg.n

    @property
    def device(self) -> torch.device:
        return self.pg.device

    def _fused_persistent(self) -> bool:
        """The whole-walk kernel runs when the layout lets it: fused +
        pipeline, exact sampling, FN-Base (no hot set), length >= 2.
        Otherwise the per-step kernel runs; walks are identical."""
        return (self.plan.backend == "fused" and self.plan.pipeline
                and self._sampler.mode == "exact" and self.plan.length >= 2
                and self._no_hot)

    def _update_meta(self):
        """(graph_version, delta_edges, invalidated fraction), taken when a
        run is enqueued, so streamed rounds report the graph they walked."""
        gv = self.store.version if self.store is not None else 0
        return (gv, self._delta_edges, self._last_invalidated_fraction)

    def _dispatch(self, starts, seed: int, walker_ids):
        """Enqueue one run; returns (walks tensor on the device, the
        update snapshot)."""
        dev = self.device
        key = jr.PRNGKey(seed, device=dev)
        if starts is None:
            starts = np.arange(self.pg.n, dtype=np.int32)
        starts = torch.as_tensor(np.asarray(starts, np.int32), device=dev)
        walker_ids = starts if walker_ids is None else torch.as_tensor(
            np.asarray(walker_ids, np.int32), device=dev)
        run = run_fused_persistent if self._fused_persistent() \
            else run_reference
        walks = run(self.pg, starts, walker_ids.long(), key, self._sampler,
                    self.plan.length)
        return walks, self._update_meta()

    def _finalize(self, dispatched) -> WalkResult:
        walks, (gv, delta_edges, inv_frac) = dispatched
        walks = walks.cpu().numpy()
        stats = WalkStats(backend=self.plan.backend,
                          walkers=int(walks.shape[0]),
                          supersteps=self.plan.length, graph_version=gv,
                          delta_edges=delta_edges,
                          invalidated_shard_fraction=inv_frac)
        return WalkResult(walks=walks, stats=stats)

    def run(self, starts=None, seed: int = 0, walker_ids=None) -> WalkResult:
        """Walk ``starts`` (default: every vertex) with the bound plan."""
        return self._finalize(self._dispatch(starts, seed, walker_ids))

    def rounds(self, num_rounds: int, seed: int = 0,
               start: int = 0) -> Iterator[WalkResult]:
        """FN-Multi rounds: round ``k+1`` is enqueued on the device before
        round ``k`` is copied to the host and yielded."""
        if num_rounds <= start:
            return
        pending = self._dispatch(None, round_seed(seed, start), None)
        for r in range(start, num_rounds):
            nxt = self._dispatch(None, round_seed(seed, r + 1), None) \
                if r + 1 < num_rounds else None
            yield self._finalize(pending)
            pending = nxt

    def update(self, deltas) -> UpdateReport:
        """Apply edge deltas to the resident graph without a whole-graph
        rebuild: the store patches the host CSR shard-locally, then only
        the affected rows' adjacency, alias tables and FN-Cache hot entries
        are spliced into a new layout (a full relayout only when the
        layout's shapes can no longer hold the new graph). Walks after
        ``update()`` equal those of an engine built from scratch at the
        same store version."""
        if self.store is None:
            raise ValueError(
                "update() needs the engine's GraphStore — build the engine "
                "from a spec string, CSRGraph, Dataset, or GraphStore (a "
                "prebuilt PaddedGraph carries no host CSR to patch)")
        patch = self.store.apply(deltas)
        self.pg, relayout, hot_rows = patch_padded(
            self.pg, self.store.graph, patch.affected, self.plan.cap,
            self.plan.hot_cap)
        if relayout:
            self._no_hot = int(self.pg.hot_pos.max()) < 0
        device_shards = patch.num_shards
        invalidated = device_shards if relayout \
            else int(len(patch.affected_shards))
        self._delta_edges += patch.delta_edges
        self._last_invalidated_fraction = invalidated / max(device_shards, 1)
        return UpdateReport(
            patch=patch, version=self.store.version, relayout=relayout,
            device_shards=device_shards,
            invalidated_device_shards=invalidated,
            hot_rows_updated=hot_rows)
