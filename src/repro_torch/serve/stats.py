"""ServeStats — the serving layer's structured diagnostics, port of
``repro.serve.stats``, mirroring ``repro_torch.engine.plan.WalkStats``.

The walk engine reports what one *run* did (supersteps, drops, collective
bytes); the serving layer reports what a *traffic window* did: request
latency quantiles, sustained QPS, cache hit rate, and how full the
fixed-shape batches actually were. ``StatsRecorder`` is the mutable
accumulator the service feeds per event; :meth:`StatsRecorder.snapshot`
freezes it into a :class:`ServeStats` record.

Latency is recorded against the service clock (injectable — the smoke
bench replays traces on a virtual clock so occupancy/hit-rate metrics are
deterministic; the launcher uses the real clock so p50/p99 measure actual
compute).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Frozen per-window serving diagnostics.

    ``requests``        — completed requests (answered, from cache or batch).
    ``expired``         — requests shed because their deadline passed before
                          a batch picked them up (starved queue / overload);
                          not counted in ``requests`` or the latency stats.
    ``batches``         — batches actually launched (cache hits and
                          expiries never reach a batch).
    ``p50_latency_us``  — median submit→response latency.
    ``p99_latency_us``  — tail latency (the serving SLO quantity).
    ``qps``             — completed requests / window wall time.
    ``cache_hit_rate``  — hits / (hits + misses) over result-cache lookups.
    ``batch_occupancy`` — mean(real items / bucket slots) over launched
                          batches; low occupancy means the coalescer is
                          padding, high means buckets are sized right.
    """
    requests: int = 0
    expired: int = 0
    batches: int = 0
    p50_latency_us: float = 0.0
    p99_latency_us: float = 0.0
    qps: float = 0.0
    cache_hit_rate: float = 0.0
    batch_occupancy: float = 0.0


class StatsRecorder:
    """Mutable accumulator behind :class:`ServeStats`."""

    def __init__(self) -> None:
        self._latencies_us: list[float] = []
        self.hits = 0
        self.misses = 0
        self.expired = 0
        self._occupancies: list[float] = []
        self._t_first: float | None = None
        self._t_last: float | None = None

    # ------------------------------------------------------------ events --
    def request_submitted(self, now: float) -> None:
        if self._t_first is None or now < self._t_first:
            self._t_first = now

    def request_completed(self, t_submit: float, now: float) -> None:
        self._latencies_us.append((now - t_submit) * 1e6)
        if self._t_last is None or now > self._t_last:
            self._t_last = now

    def request_expired(self) -> None:
        self.expired += 1

    def cache_lookup(self, hit: bool) -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def batch_launched(self, real_items: int, bucket: int) -> None:
        self._occupancies.append(real_items / max(bucket, 1))

    # ---------------------------------------------------------- snapshot --
    def snapshot(self) -> ServeStats:
        lat = np.asarray(self._latencies_us, np.float64)
        window = 0.0
        if self._t_first is not None and self._t_last is not None:
            window = max(self._t_last - self._t_first, 0.0)
        looks = self.hits + self.misses
        return ServeStats(
            requests=len(lat),
            expired=self.expired,
            batches=len(self._occupancies),
            p50_latency_us=float(np.percentile(lat, 50)) if lat.size else 0.0,
            p99_latency_us=float(np.percentile(lat, 99)) if lat.size else 0.0,
            qps=len(lat) / window if window > 0 else 0.0,
            cache_hit_rate=self.hits / looks if looks else 0.0,
            batch_occupancy=float(np.mean(self._occupancies))
            if self._occupancies else 0.0,
        )
