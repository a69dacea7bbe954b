"""EmbeddingService — online node-embedding queries over a resident graph
and a trained SGNS table; port of ``repro.serve.service``.

One service instance holds, on its device:

* the FN-Cache graph layout (``PaddedGraph``: capped cold rows + hot rows),
  the same tensors the walk engine samples from;
* the L2-normalized SGNS ``emb`` table ``[V, D]``.

Two query kinds:

* ``embed(nodes, window=0)`` — gather rows; with ``window > 0`` the
  normalized mean of the node's row and a ``window``-step node2vec walk
  context from it. Walks run through a ``WalkEngine`` on the resident
  layout with walker id == node id, so a node's embedding is a pure
  function of (node, service seed), whatever batch it rides in: coalesced
  serving equals per-request serving bit for bit. On the ``fused`` backend
  every superstep of such a walk is one ``node2vec_step`` launch.
* ``rank_neighbors(node, k)`` — top-k dot-product ranking of a candidate
  set: the node's graph neighbours (default) or the whole table
  (``scope="all"``). Equal scores keep the lower candidate index first, as
  ``jax.lax.top_k`` does.

The request path is ``submit() -> pump()`` through a
:class:`~repro_torch.serve.batcher.DeadlineBatcher` (fixed bucket shapes)
with a :class:`~repro_torch.serve.cache.ResultCache` in front (LRU,
hot-set admission). ``stats()`` snapshots the
:class:`~repro_torch.serve.stats.ServeStats` window. ``refresh(deltas)``
applies edge deltas without taking the service down.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import PaddedGraph
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.engine.update import patch_padded
from repro_torch.serve.batcher import (DEFAULT_BUCKETS, DeadlineBatcher,
                                       Response, bucket_for)
from repro_torch.serve.cache import (Admission, ResultCache,
                                     hot_set_admission, prefix_admission)
from repro_torch.serve.stats import ServeStats, StatsRecorder


# ------------------------------------------------------ query functions --
# The JAX package's four jitted functions (gather, walk average, two
# rankings), as plain torch on the table's device. Ids read through
# ``_rows`` clamp to the table as JAX's gathers do (a walk that drew
# PAD_ID reads the last row).

def _rows(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return emb[ids.long().clamp(0, emb.shape[0] - 1)]


def _top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, equal scores
    in ascending index order (a stable descending sort)."""
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k]


def _walk_avg(emb: torch.Tensor, nodes: torch.Tensor,
              walks: torch.Tensor) -> torch.Tensor:
    ctx = _rows(emb, walks)                               # [B, window, D]
    mean = (_rows(emb, nodes) + ctx.sum(dim=1)) / (walks.shape[1] + 1)
    return mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
                   + 1e-8)


def _rank_neighbors(emb: torch.Tensor, nodes: torch.Tensor,
                    cand: torch.Tensor, k: int):
    """(ids [B, k], scores [B, k]); ids -1 where the score is not finite,
    candidates padded with -inf / -1 when ``k`` exceeds their width."""
    q = _rows(emb, nodes)                                 # [B, D]
    ce = _rows(emb, cand)                                 # [B, W, D]
    # a row-wise reduction: equal candidate rows give equal scores
    scores = torch.where(cand >= 0, (ce * q[:, None, :]).sum(dim=-1),
                         -math.inf)
    if k > scores.shape[1]:
        fill = (scores.shape[0], k - scores.shape[1])
        scores = torch.cat([scores, scores.new_full(fill, -math.inf)], 1)
        cand = torch.cat([cand, cand.new_full(fill, -1)], 1)
    top_s, top_i = _top_k(scores, k)
    top_ids = torch.gather(cand, 1, top_i)
    return torch.where(torch.isfinite(top_s), top_ids, -1), top_s


def _rank_all(emb: torch.Tensor, nodes: torch.Tensor, k: int):
    """(scores [B, k], ids [B, k]) over the whole table, the query's own
    entry excluded."""
    scores = _rows(emb, nodes) @ emb.T                    # [B, V]
    scores[torch.arange(nodes.shape[0], device=emb.device),
           nodes.long()] = -math.inf
    top_s, top_i = _top_k(scores, k)
    return top_s, top_i.to(torch.int32)


class EmbeddingService:
    """Resident-state serving over one graph and one embedding table.

    ``graph`` is anything :func:`~repro_torch.data.store.open_graph`
    accepts; the service holds the store and applies edge deltas through
    :meth:`refresh`. ``device=None`` means the card; the tests pass
    ``device="cpu"``.
    """

    def __init__(self, graph, emb, *,
                 plan: Optional[WalkPlan] = None,
                 cache_size: int = 1024,
                 admission: Union[str, Admission, None] = "hot",
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 linger_s: float = 0.0, margin_s: float = 0.0,
                 walk_seed: int = 0, clock=time.monotonic,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.store = open_graph(graph)
        graph = self.store.graph
        self.graph = graph
        self.plan = plan or WalkPlan(backend="reference")
        if isinstance(emb, dict):            # raw SGNS params
            from repro_torch.core.skipgram import serving_table
            emb = serving_table(emb)
        if torch.is_tensor(emb):
            emb = emb.detach().cpu().numpy()
        emb = np.asarray(emb, np.float32)
        if emb.ndim != 2 or emb.shape[0] < graph.n:
            raise ValueError(
                f"emb must be [V >= n, D], got {emb.shape} for n={graph.n}")
        self.emb = torch.from_numpy(emb).to(self.device)
        self.dim = int(emb.shape[1])
        # resident FN-Cache layout, shared by every per-window walk engine
        self._pg = PaddedGraph.build(graph, cap=self.plan.cap,
                                     hot_cap=self.plan.hot_cap,
                                     device=self.device)
        self._engines: Dict[int, WalkEngine] = {}
        self._cand_width = max(graph.max_degree, 1)
        if admission == "hot":
            # the FN-Cache hot set when the layout has one; else the top
            # cache_size vertices by degree
            if self.plan.cap is not None:
                admission = hot_set_admission(graph.deg, self.plan.cap)
            else:
                order = np.argsort(-graph.deg.astype(np.int64),
                                   kind="stable")
                hot = np.zeros(graph.n, bool)
                hot[order[:cache_size]] = True
                admission = lambda v: bool(0 <= v < graph.n and hot[v])
        elif isinstance(admission, str) and admission.startswith("prefix:"):
            admission = prefix_admission(int(admission.split(":", 1)[1]))
        self.cache = ResultCache(cache_size, admit=admission)
        self.batcher = DeadlineBatcher(tuple(buckets), linger_s=linger_s,
                                       margin_s=margin_s)
        self.recorder = StatsRecorder()
        self.walk_seed = walk_seed
        self.clock = clock
        self._ready: List[Response] = []
        self.compiled_shapes: set = set()   # (query, bucket, ...) presented

    # ------------------------------------------------------------- build --
    @classmethod
    def from_node2vec(cls, graph, cfg, device=None,
                      **kw) -> "EmbeddingService":
        """Run the whole pipeline (walks -> SGNS) and serve the result."""
        from repro_torch.core.node2vec import node2vec
        store = open_graph(graph)
        emb = node2vec(store.graph, cfg, device=device)
        plan = kw.pop("plan", None) or dataclasses.replace(
            cfg.plan(), backend="reference")
        return cls(store, emb, plan=plan, device=device, **kw)

    # ------------------------------------------------------------ refresh --
    def refresh(self, deltas) -> dict:
        """Apply edge deltas without taking the service down: the store
        patches the host CSR, the affected rows are spliced into a new
        resident layout (``repro_torch.engine.update.patch_padded``), the
        per-window walk engines are rebound to it, and cached results keyed
        on affected nodes are dropped. The admission predicate's degree
        snapshot and the embedding table stay as they were. Returns a
        report dict."""
        patch = self.store.apply(deltas)
        self.graph = self.store.graph
        aff = patch.affected
        self._pg, relayout, hot_rows = patch_padded(
            self._pg, self.graph, aff, self.plan.cap, self.plan.hot_cap)
        self._engines.clear()
        # the rank candidate width only grows, so bucket shapes stay valid
        self._cand_width = max(self._cand_width, self.graph.max_degree, 1)
        dropped = self.cache.invalidate_nodes(aff)
        return {
            "version": self.store.version,
            "relayout": relayout,
            "num_affected": int(patch.num_affected),
            "delta_edges": int(patch.delta_edges),
            "invalidated_fraction":
                1.0 if relayout else float(patch.shard_fraction),
            "hot_rows_updated": int(hot_rows),
            "cache_entries_dropped": int(dropped),
        }

    # ------------------------------------------------------------ warming --
    def warm_from_walks(self, walks, *, window: int = 0,
                        top: Optional[int] = None) -> int:
        """Pre-populate the cache from walk-visit counts: rank vertices by
        visits in ``walks`` (any ``[W, L]`` int array), keep the admitted
        ones, and compute their ``("embed", node, window)`` entries through
        the batched path (equal to what a cold query computes). ``top``
        caps how many (default: the cache capacity). Returns the number of
        entries cached."""
        counts = np.bincount(
            np.asarray(walks, np.int64).ravel(), minlength=self.graph.n)
        order = np.argsort(-counts, kind="stable")
        order = order[counts[order] > 0]
        if self.cache.admit is not None:
            order = np.asarray([v for v in order if self.cache.admit(int(v))],
                               np.int64)
        budget = self.cache.capacity if top is None else min(
            top, self.cache.capacity)
        nodes = order[:budget].astype(np.int32)
        warmed = 0
        step = max(self.batcher.buckets)
        for i in range(0, len(nodes), step):
            chunk = nodes[i:i + step]
            rows = self.embed(chunk, window=window)
            for v, val in zip(chunk, rows):
                warmed += self.cache.put(("embed", int(v), window), val,
                                         node=int(v))
        return warmed

    def _engine_for(self, window: int) -> WalkEngine:
        eng = self._engines.get(window)
        if eng is None:
            plan = dataclasses.replace(self.plan, length=window)
            eng = WalkEngine.build(self._pg, plan)
            self._engines[window] = eng
        return eng

    # ----------------------------------------------------- direct queries --
    def _pad(self, nodes: np.ndarray) -> Tuple[np.ndarray, int]:
        b = bucket_for(len(nodes), self.batcher.buckets)
        padded = np.zeros(b, np.int32)
        padded[:len(nodes)] = nodes
        return padded, b

    def embed(self, nodes, window: int = 0) -> np.ndarray:
        """[B, D] embeddings for ``nodes`` — the direct batched path; the
        queued path computes through this same code."""
        nodes = np.atleast_1d(np.asarray(nodes, np.int32))
        padded, b = self._pad(nodes)
        tnodes = torch.from_numpy(padded).to(self.device)
        if window <= 0:
            self.compiled_shapes.add(("gather", b))
            out = _rows(self.emb, tnodes)
        else:
            res = self._engine_for(window).run(
                starts=padded, seed=self.walk_seed, walker_ids=padded)
            self.compiled_shapes.add(("walk_avg", b, window))
            out = _walk_avg(self.emb, tnodes,
                            torch.from_numpy(res.walks).to(self.device))
        return out.cpu().numpy()[:len(nodes)]

    def _neighbor_rows(self, nodes: np.ndarray) -> np.ndarray:
        rows = np.full((len(nodes), self._cand_width), -1, np.int32)
        for i, v in enumerate(nodes):
            nb = self.graph.neighbors(int(v))
            rows[i, :len(nb)] = nb
        return rows

    def rank_neighbors(self, nodes, k: int,
                       scope: str = "neighbors"
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` candidates by dot product for each query node:
        ``(ids [B, k], scores [B, k])``; ids are -1 past the candidate
        count. ``scope="neighbors"`` ranks the node's graph neighbourhood;
        ``"all"`` scans the whole table."""
        if scope not in ("neighbors", "all"):
            raise ValueError(f"scope must be neighbors|all, got {scope!r}")
        nodes = np.atleast_1d(np.asarray(nodes, np.int32))
        padded, b = self._pad(nodes)
        tnodes = torch.from_numpy(padded).to(self.device)
        if scope == "all":
            self.compiled_shapes.add(("rank_all", b, k))
            top_s, top_i = _rank_all(self.emb, tnodes, k)
        else:
            cand = torch.from_numpy(self._neighbor_rows(padded))
            self.compiled_shapes.add(("rank", b, k))
            top_i, top_s = _rank_neighbors(self.emb, tnodes,
                                           cand.to(self.device), k)
        ids, scores = top_i.cpu().numpy(), top_s.cpu().numpy()
        return ids[:len(nodes)], scores[:len(nodes)]

    # ----------------------------------------------------- queued serving --
    def submit(self, kind: str, node: int, *, window: int = 0,
               k: int = 10, scope: str = "neighbors",
               deadline_s: float = math.inf,
               now: Optional[float] = None) -> int:
        """Enqueue one query; returns its request id. Cache hits are
        answered at once (delivered by the next ``pump``)."""
        explicit = now is not None
        now = self.clock() if not explicit else now
        self.recorder.request_submitted(now)
        if kind == "embed":
            key = ("embed", int(node), window)
            group = ("embed", window)
        elif kind == "rank":
            key = ("rank", int(node), k, scope)
            group = ("rank", k, scope)
        else:
            raise ValueError(f"kind must be embed|rank, got {kind!r}")
        cached = self.cache.get(key)
        self.recorder.cache_lookup(cached is not None)
        if cached is not None:
            rid = self.batcher.next_rid()        # answered without queueing
            done = now if explicit else self.clock()
            self._ready.append(Response(rid=rid, value=cached,
                                        t_submit=now, t_done=done))
            self.recorder.request_completed(now, done)
            return rid
        req = self.batcher.submit(group, node,
                                  deadline=now + deadline_s, now=now)
        return req.rid

    def _compute_group(self, group: Tuple, nodes: np.ndarray) -> list:
        """Batched compute for the unique ``nodes`` of one group: one value
        per node (a row, or an (ids, scores) pair)."""
        if group[0] == "embed":
            out = self.embed(nodes, window=group[1])
            return [out[i] for i in range(len(nodes))]
        _, k, scope = group
        ids, scores = self.rank_neighbors(nodes, k, scope=scope)
        return [(ids[i], scores[i]) for i in range(len(nodes))]

    def pump(self, now: Optional[float] = None,
             drain: bool = False) -> List[Response]:
        """Flush due batches and return completed and expired responses
        (and any cache hits since the last pump). A caller that passes
        ``now`` owns the time base (replay on a virtual clock); otherwise
        the service clock stamps completions after each batch, so
        latencies include compute."""
        explicit = now is not None
        now = self.clock() if not explicit else now
        responses, self._ready = self._ready, []
        for group, live, dead in self.batcher.due(now, drain=drain):
            for r in dead:
                self.recorder.request_expired()
                responses.append(Response(rid=r.rid, value=None, expired=True,
                                          t_submit=r.t_submit, t_done=now))
            if not live:
                continue
            uniq, inv = np.unique(
                np.asarray([r.node for r in live], np.int64),
                return_inverse=True)
            bucket = bucket_for(len(uniq), self.batcher.buckets)
            self.recorder.batch_launched(len(uniq), bucket)
            values = self._compute_group(group, uniq.astype(np.int32))
            done = now if explicit else self.clock()
            for r, j in zip(live, inv):
                value = values[int(j)]
                if group[0] == "embed":
                    self.cache.put(("embed", r.node, group[1]), value,
                                   node=r.node)
                else:
                    self.cache.put(("rank", r.node, group[1], group[2]),
                                   value, node=r.node)
                responses.append(Response(rid=r.rid, value=value,
                                          t_submit=r.t_submit, t_done=done))
                self.recorder.request_completed(r.t_submit, done)
        return responses

    def drain(self, now: Optional[float] = None) -> List[Response]:
        return self.pump(now=now, drain=True)

    def stats(self) -> ServeStats:
        return self.recorder.snapshot()
