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


def round_seed(seed: int, r: int) -> int:
    """Per-round seed for FN-Multi rounds (as in the JAX package)."""
    return seed * 1000003 + r


class WalkEngine:
    """Executable walk workload: a plan bound to a device layout."""

    def __init__(self, plan: WalkPlan, pg: PaddedGraph, store=None):
        self.plan = plan
        self.pg = pg
        self.store = store
        self._sampler = plan.sampler()
        self._no_hot = int(pg.hot_pos.max()) < 0

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

    def _dispatch(self, starts, seed: int, walker_ids) -> torch.Tensor:
        """Enqueue one run; returns the walks tensor on the device."""
        dev = self.device
        key = jr.PRNGKey(seed, device=dev)
        if starts is None:
            starts = np.arange(self.pg.n, dtype=np.int32)
        starts = torch.as_tensor(np.asarray(starts, np.int32), device=dev)
        walker_ids = starts if walker_ids is None else torch.as_tensor(
            np.asarray(walker_ids, np.int32), device=dev)
        run = run_fused_persistent if self._fused_persistent() \
            else run_reference
        return run(self.pg, starts, walker_ids.long(), key, self._sampler,
                   self.plan.length)

    def _finalize(self, walks: torch.Tensor) -> WalkResult:
        walks = walks.cpu().numpy()
        stats = WalkStats(backend=self.plan.backend,
                          walkers=int(walks.shape[0]),
                          supersteps=self.plan.length)
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
