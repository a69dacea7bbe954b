"""Result cache for hot nodes — LRU eviction, FN-Cache-style admission;
port of ``repro.serve.cache`` (host Python).

The walk layer's FN-Cache observation (paper §3.4) carries over to serving
unchanged: Zipf traffic concentrates on exactly the vertices whose degree is
highest, so a small replicated structure keyed on the hot set absorbs most
of the load. Here the structure is a result cache, and the *admission*
policy — not just eviction — is what keeps it hot: a one-off cold query must
not evict a hub's entry, so cold nodes bypass the cache entirely.

Two admission predicates reuse the existing hot-set machinery:

* :func:`hot_set_admission` — membership in the FN-Cache hot set
  (``degree > cap``), taken from the resident graph's degrees; identical to
  the set ``PaddedGraph.build`` replicates.
* :func:`prefix_admission` — ``id < K``: under the ingest registry's
  ``relabel=degree`` the hot set is the contiguous id prefix, so
  admission is a single compare, no lookup table.

Keys are opaque tuples (the service uses ``(kind, node, ...)``); admission
sees only the node id.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional

import numpy as np

Admission = Callable[[int], bool]


def prefix_admission(k: int) -> Admission:
    """Admit node ids in the contiguous hot prefix ``[0, k)`` — the
    ``relabel=degree`` layout where degree rank == vertex id."""
    return lambda node: 0 <= node < k


def hot_set_admission(deg: np.ndarray, cap: int) -> Admission:
    """Admit the FN-Cache hot set: nodes with ``degree > cap`` (the same
    vertices whose rows ``PaddedGraph.build``/``ShardedGraph`` replicate)."""
    hot = np.asarray(deg) > cap

    def admit(node: int) -> bool:
        return bool(0 <= node < hot.shape[0] and hot[node])

    return admit


class ResultCache:
    """LRU cache over query results with an admission predicate.

    ``get`` refreshes recency on hit; ``put`` inserts only if the admission
    predicate accepts the node (rejections are not errors — the caller just
    serves the computed value uncached). Eviction is strict LRU among the
    admitted entries. ``hits``/``misses`` counters feed ``ServeStats``.
    """

    def __init__(self, capacity: int,
                 admit: Optional[Admission] = None) -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.admit = admit
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        """Keys in eviction order: least-recently-used first."""
        return list(self._entries.keys())

    def get(self, key: Hashable):
        """Value for ``key`` (refreshing recency) or None; counts hit/miss."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        self.misses += 1
        return None

    def invalidate_nodes(self, nodes) -> int:
        """Drop every entry keyed on one of ``nodes`` (the second element
        of a tuple key, the service convention) — the serving side of a
        graph delta: results computed from a patched vertex's old row must
        not outlive it. Returns the number of entries dropped."""
        ns = {int(v) for v in np.asarray(nodes, np.int64).ravel()}
        if not ns:
            return 0
        drop = [k for k in self._entries
                if isinstance(k, tuple) and len(k) > 1 and int(k[1]) in ns]
        for k in drop:
            del self._entries[k]
        return len(drop)

    def put(self, key: Hashable, value: Any, node: Optional[int] = None
            ) -> bool:
        """Insert ``value`` if admission accepts ``node`` (default: the
        second element of a tuple key, the service's key convention).
        Returns True iff the entry was admitted."""
        if node is None and isinstance(key, tuple) and len(key) > 1:
            node = key[1]
        if self.admit is not None and node is not None \
                and not self.admit(int(node)):
            return False
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return True
