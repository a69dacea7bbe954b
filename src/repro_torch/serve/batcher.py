"""Deadline-aware request coalescing into fixed-shape batches — port of
``repro.serve.batcher`` (host Python, unchanged semantics).

A serving loop that launched one gather per request would serialize on
tiny kernel launches; one that took batches of whatever size happened to
be queued would present unbounded shapes (the JAX package recompiles per
shape). The coalescer holds the middle ground:

* Requests queue per *group* (query kind + its static params, e.g.
  ``("embed", window)`` — groups share one batched query function).
* A group flushes when it can fill the largest bucket, when its oldest
  request has lingered ``linger_s`` (latency floor), or when any member's
  deadline is within ``margin_s`` of now (deadline-aware: a request about to
  expire pulls its batchmates along instead of waiting for occupancy).
* Flushed batches are padded **up** to the smallest bucket that fits
  (``buckets`` is the full set of shapes the service ever compiles — no
  per-request recompiles by construction).
* Requests whose deadline already passed at flush time are *shed*: they get
  an ``expired`` response without touching the accelerator (overload sheds
  work instead of queueing it — the starved-queue tests pin this down).

The batcher is single-threaded and pull-based: callers ``submit`` then
``due(now)``/``drain(now)``. Time is an explicit argument everywhere, so
trace replay on a virtual clock is deterministic regardless of machine load
— same request multiset in a different arrival order gives bit-identical
responses (tested).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Hashable, List, Optional, Tuple

DEFAULT_BUCKETS = (8, 32, 128)


@dataclasses.dataclass
class Request:
    """One enqueued query. ``group`` picks the kernel; ``node``/``extra``
    are its payload; ``deadline`` is absolute service-clock time (+inf =
    never expires)."""
    rid: int
    group: Tuple
    node: int
    extra: Tuple = ()
    deadline: float = math.inf
    t_submit: float = 0.0


@dataclasses.dataclass
class Response:
    """Answer to one request. ``expired`` responses carry ``value=None``."""
    rid: int
    value: Any
    expired: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket holding ``n`` items (callers never exceed the largest
    bucket per flush)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class DeadlineBatcher:
    """Per-group request queues + the flush policy described above."""

    def __init__(self, buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 linger_s: float = 0.0, margin_s: float = 0.0) -> None:
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_bucket = self.buckets[-1]
        self.linger_s = linger_s
        self.margin_s = margin_s
        self._queues: Dict[Hashable, List[Request]] = {}
        self._rid = itertools.count()

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def next_rid(self) -> int:
        """Allocate a request id without queueing (cache-hit fast path)."""
        return next(self._rid)

    def submit(self, group: Tuple, node: int, extra: Tuple = (),
               deadline: float = math.inf, now: float = 0.0) -> Request:
        req = Request(rid=next(self._rid), group=group, node=int(node),
                      extra=tuple(extra), deadline=deadline, t_submit=now)
        self._queues.setdefault(group, []).append(req)
        return req

    # ------------------------------------------------------------ flushes --
    def _flush_group(self, q: List[Request], force: bool,
                     now: float) -> List[List[Request]]:
        out = []
        while len(q) >= self.max_bucket:
            out.append(q[:self.max_bucket])
            del q[:self.max_bucket]
        if q and (force
                  or now - q[0].t_submit >= self.linger_s
                  or min(r.deadline for r in q) - now <= self.margin_s):
            out.append(q[:])
            q.clear()
        return out

    def due(self, now: float, drain: bool = False
            ) -> List[Tuple[Hashable, List[Request], List[Request]]]:
        """Batches ready to launch at ``now``: a list of
        ``(group, live_requests, expired_requests)``. ``drain=True`` flushes
        everything regardless of linger/occupancy (end of trace / shutdown).
        Within a batch, requests keep submission order — with the
        per-request RNG keyed on node id (never batch position), response
        values are a pure function of the request, so arrival order cannot
        change them."""
        ready = []
        for group in sorted(self._queues, key=repr):
            for batch in self._flush_group(self._queues[group], drain, now):
                live = [r for r in batch if r.deadline >= now]
                dead = [r for r in batch if r.deadline < now]
                ready.append((group, live, dead))
        return ready

    def drain(self, now: float):
        return self.due(now, drain=True)


class VirtualClock:
    """Deterministic clock for trace replay: ``now`` advances only when the
    replay loop says so. Also callable, matching ``time.monotonic``'s shape."""

    def __init__(self, start: float = 0.0) -> None:
        self.t = start

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t
