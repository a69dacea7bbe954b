"""Online node-embedding serving over the resident graph and SGNS table —
port of ``repro.serve``.

    service = EmbeddingService(graph, emb, plan=WalkPlan(cap=32))
    rid = service.submit("rank", node, k=10, deadline_s=0.05)
    for resp in service.pump(): ...
    service.stats()        # ServeStats: p50/p99 latency, QPS, hit rate

Layers: ``DeadlineBatcher`` (deadline-aware coalescing into fixed bucket
shapes) -> ``ResultCache`` (LRU + FN-Cache hot-set admission) ->
``EmbeddingService`` (resident state + query functions) -> ``ServeStats``.
"""
from repro_torch.serve.batcher import (DEFAULT_BUCKETS, DeadlineBatcher,
                                       Request, Response, VirtualClock,
                                       bucket_for)
from repro_torch.serve.cache import (ResultCache, hot_set_admission,
                                     prefix_admission)
from repro_torch.serve.service import EmbeddingService
from repro_torch.serve.stats import ServeStats, StatsRecorder
from repro_torch.serve.trace import TraceEvent, synthetic_trace, zipf_nodes

__all__ = [
    "DEFAULT_BUCKETS", "DeadlineBatcher", "EmbeddingService", "Request",
    "Response", "ResultCache", "ServeStats", "StatsRecorder", "TraceEvent",
    "VirtualClock", "bucket_for", "hot_set_admission", "prefix_admission",
    "synthetic_trace", "zipf_nodes",
]
