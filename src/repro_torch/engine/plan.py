"""WalkPlan / WalkStats / WalkResult — port of ``repro.engine.plan``.

A :class:`WalkPlan` describes *what* to walk (p, q, length, mode, eps) and
*how* (backend, layout and the sharded exchange's capacity);
:class:`~repro_torch.engine.engine.WalkEngine` binds it to a graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

BACKENDS = ("reference", "sharded", "fused")


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """Frozen description of a walk workload.

    ``cap=None`` -> FN-Base (rows at max degree, no hot set);
    ``cap < max degree`` -> FN-Cache (popular rows in the hot cache).
    ``pipeline`` on the fused backend runs the whole walk in one
    ``node2vec_walk`` launch where the layout allows (exact mode, FN-Base);
    on the sharded backend it overlaps each walker cohort's exchange with
    the other cohort's sampling; on the reference backend it changes
    nothing. Walks are identical either way.
    """
    p: float = 1.0
    q: float = 1.0
    length: int = 80
    mode: str = "exact"               # exact | approx | approx_always
    approx_eps: float = 1e-3
    backend: str = "reference"        # reference | sharded | fused
    cap: Optional[int] = None         # cold row width (None -> FN-Base)
    hot_cap: Optional[int] = None     # hot row width (None -> max hot degree)
    capacity: Optional[object] = None  # sharded: request slots per
                                      # destination per exchange. int, None
                                      # (zero drops at any skew) or "auto"
                                      # (``roofline.traffic.
                                      # walk_auto_capacity``)
    strict_drops: bool = False        # raise (not warn) when requests drop
    pipeline: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.length < 1:
            raise ValueError(f"length must be >= 1, got {self.length}")
        cap = self.capacity
        ok = cap is None or cap == "auto" or \
            (isinstance(cap, (int, np.integer)) and cap >= 1)
        if not ok:
            raise ValueError(
                f"capacity must be None, 'auto', or a positive int, "
                f"got {cap!r}")

    def sampler(self):
        from repro_torch.engine.sampler import Sampler
        return Sampler(p=self.p, q=self.q, mode=self.mode,
                       eps=self.approx_eps, fused=self.backend == "fused")


@dataclasses.dataclass(frozen=True)
class WalkStats:
    """Per-run diagnostics; ``supersteps`` equals the walk length.

    ``dropped``            — NEIG requests past the sharded exchange's
                             capacity (the walker stayed put for that
                             step), summed over the world; 0 on one
                             device.
    ``collective_bytes``   — analytic per-rank exchange bytes of the run
                             (``roofline.traffic``; 0 off the sharded
                             backend or in a world of one).
    ``exposed_collective_bytes`` — the part of ``collective_bytes`` on the
                             superstep's critical path: all of it in
                             barrier mode, less when pipelined
                             (``walk_overlap_model`` at the H100's
                             rates).
    ``overlap_efficiency`` — ``1 - exposed / total`` (0 with nothing on the
                             wire).
    ``graph_version``      — the GraphStore delta counter this run walked
                             (stamped when the run is enqueued, so streamed
                             rounds report the version they walked); 0
                             without a store.
    ``delta_edges``        — cumulative edge events applied through
                             ``WalkEngine.update`` so far.
    ``invalidated_shard_fraction`` — fraction of patch shards the last
                             ``update`` rewrote (1.0 on a relayout, 0.0
                             before any update).
    """
    backend: str
    walkers: int
    supersteps: int
    dropped: int = 0
    collective_bytes: int = 0
    exposed_collective_bytes: int = 0
    overlap_efficiency: float = 0.0
    graph_version: int = 0
    delta_edges: int = 0
    invalidated_shard_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class WalkResult:
    """Host-side walks [W, length] int32 plus their stats. Walks run on a
    card reach the host in page-locked memory, which ``walks`` holds for
    as long as it lives."""
    walks: np.ndarray
    stats: WalkStats
