"""Analytic per-device traffic of the sharded walk and the sharded SGNS
trainer — port of the walk half of ``repro.roofline.traffic``.

Napkin math kept in code: the NEIG exchange's bytes follow from its
shapes, ``walk_auto_capacity`` sizes the exchange from the degree
distribution, and ``walk_overlap_model`` estimates how much of the
pipelined walk's exchange can hide behind the other cohort's sampling.
The rates the overlap model divides by default to one NVIDIA H100 SXM
(NVIDIA's data sheet, at its 700 W limit); a caller may pass others.
Nothing here is a measurement, and none of it gates a result.

The LM half of the JAX module (``analytic_bytes``,
``param_bytes_per_device``) waits for the LM trainer (ROADMAP item 12).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

F32 = 4
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores
H100_HBM_BW = 3.35e12       # bytes/s of device memory
H100_NVLINK_BW = 450e9      # bytes/s one way (900 GB/s both ways)


def walk_exchange_bytes(num_shards: int, capacity: int, cap: int,
                        w_bytes: int = F32) -> int:
    """Per-device bytes of ONE two-phase NEIG exchange: the request buffer
    (S x C x 4B ids out) plus the response rows (S x C x cap x (4B ids +
    w_bytes weights))."""
    return num_shards * capacity * (4 + cap * (4 + w_bytes))


def walk_collective_bytes(num_shards: int, capacity: int, cap: int,
                          length: int, w_bytes: int = F32) -> int:
    """Per-device NEIG-exchange bytes of one barrier-mode walk: one
    exchange per superstep after step 0, which is local."""
    per_step = walk_exchange_bytes(num_shards, capacity, cap, w_bytes)
    return per_step * max(length - 1, 0)


def sgns_exchange_bytes(u_rows: int, dim: int, num_shards: int,
                        w_bytes: int = F32) -> int:
    """Per-device collective bytes of one sharded SGNS step: the
    ``u_rows x dim`` owner-gather buffers through a ring all-reduce,
    ``2·(S−1)/S·u_rows·dim·4``; 0 at one shard."""
    if num_shards <= 1:
        return 0
    return int(2 * (num_shards - 1) / num_shards * u_rows * dim * w_bytes)


def walk_auto_capacity(deg, cap: Optional[int], num_shards: int,
                       walkers_per_shard: int, safety: float = 4.0,
                       floor: int = 8) -> int:
    """Per-destination exchange capacity from the degree distribution
    (``WalkPlan.capacity="auto"``).

    Only cold remote vertices take request slots, and a walk stands on a
    vertex in proportion to its degree, so the expected per-destination
    demand is ``walkers_per_shard · cold_share / num_shards`` with
    ``cold_share = sum(deg[deg <= cap]) / sum(deg)`` (1 without a hot
    set). ``safety`` covers bursts, ``floor`` tiny shards; the result never
    exceeds ``walkers_per_shard`` (the zero-drop default)."""
    deg = np.asarray(deg, np.float64)
    total = deg.sum()
    if total <= 0 or num_shards < 1:
        return max(min(floor, walkers_per_shard), 1)
    cold_share = deg[deg <= cap].sum() / total if cap is not None else 1.0
    expected = walkers_per_shard * cold_share / num_shards
    auto = int(np.ceil(safety * expected))
    auto = max(auto, min(floor, walkers_per_shard), 1)
    return min(auto, walkers_per_shard)


def walk_step_flops(walkers: int, width: int) -> float:
    """Sampling operations of one superstep: the membership test
    (width x width a walker) plus O(width) lanes of probabilities, scan
    and count."""
    return float(walkers) * (float(width) * float(width) + 8.0 * width)


def walk_step_bytes(walkers: int, width: int) -> float:
    """Device-memory bytes of one superstep's sampling: the membership
    booleans plus ~6 float32 streams a walker."""
    return float(walkers) * (float(width) * float(width) + 24.0 * width)


def walk_overlap_model(num_shards: int, capacity: int, cap: int, length: int,
                       walkers_per_shard: int, pipeline: bool,
                       w_bytes: int = F32, width: Optional[int] = None,
                       peak_flops: Optional[float] = None,
                       hbm_bw: Optional[float] = None,
                       link_bw: Optional[float] = None) -> dict:
    """Exposed-vs-total exchange bytes of one walk.

    Barrier mode: every exchange is on the superstep's critical path.
    Pipelined mode (two cohorts, ``core.walk_distributed``): each exchange
    can hide behind the other cohort's step, ``max(0, e - t · link_bw)``
    exposed, with ``t`` the larger of the hiding cohort's operation and
    memory times; cohort A's first exchange hides behind nothing.

    Returns ``{"total_bytes", "exposed_bytes", "efficiency"}``,
    ``efficiency = 1 - exposed / total`` (0 with nothing on the wire)."""
    peak_flops = peak_flops or H100_F32_FLOPS
    hbm_bw = hbm_bw or H100_HBM_BW
    link_bw = link_bw or H100_NVLINK_BW
    width = width or cap
    steps = max(length - 1, 0)
    if steps == 0 or num_shards <= 1:
        return {"total_bytes": 0, "exposed_bytes": 0, "efficiency": 0.0}
    e = walk_exchange_bytes(num_shards, capacity, cap, w_bytes)
    if not pipeline:
        return {"total_bytes": e * steps, "exposed_bytes": e * steps,
                "efficiency": 0.0}
    w_a = (walkers_per_shard + 1) // 2          # cohort A = ceil half
    w_b = walkers_per_shard - w_a

    def hide(w):
        t = max(walk_step_flops(w, width) / peak_flops,
                walk_step_bytes(w, width) / hbm_bw)
        return t * link_bw

    hide_a, hide_b = hide(w_a), hide(w_b)
    total = e * (2 * steps)
    exposed = e \
        + (steps - 1) * max(0.0, e - hide_b) \
        + steps * max(0.0, e - hide_a)
    return {"total_bytes": int(total), "exposed_bytes": int(exposed),
            "efficiency": 1.0 - exposed / total if total else 0.0}
