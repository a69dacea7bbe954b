"""WalkPlan / WalkStats / WalkResult — port of ``repro.engine.plan``.

A :class:`WalkPlan` describes *what* to walk (p, q, length, mode, eps) and
*how* (backend and layout); :class:`~repro_torch.engine.engine.WalkEngine`
binds it to a graph.
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
    elsewhere it changes nothing. Walks are identical either way.
    """
    p: float = 1.0
    q: float = 1.0
    length: int = 80
    mode: str = "exact"               # exact | approx | approx_always
    approx_eps: float = 1e-3
    backend: str = "reference"        # reference | fused
    cap: Optional[int] = None         # cold row width (None -> FN-Base)
    hot_cap: Optional[int] = None     # hot row width (None -> max hot degree)
    pipeline: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.backend == "sharded":
            raise NotImplementedError(
                "backend='sharded' is not ported yet: it is ROADMAP.md "
                "Queue 1 item 9 (Multi-device, torch.distributed)")
        if self.length < 1:
            raise ValueError(f"length must be >= 1, got {self.length}")

    def sampler(self):
        from repro_torch.engine.sampler import Sampler
        return Sampler(p=self.p, q=self.q, mode=self.mode,
                       eps=self.approx_eps, fused=self.backend == "fused")


@dataclasses.dataclass(frozen=True)
class WalkStats:
    """Per-run diagnostics; ``supersteps`` equals the walk length."""
    backend: str
    walkers: int
    supersteps: int


@dataclasses.dataclass(frozen=True)
class WalkResult:
    """Host-side walks [W, length] int32 plus their stats."""
    walks: np.ndarray
    stats: WalkStats
