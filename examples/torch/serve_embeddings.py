"""Serve node embeddings online: graph -> walks -> SGNS -> EmbeddingService
— the PyTorch port of ``examples/serve_embeddings.py``.

The serving-side companion of quickstart.py. Trains a small node2vec
model, makes it resident in an EmbeddingService, then answers the two
production query shapes — "embed this node" and "rank this node's
neighbors" — first directly, then through the deadline-aware request queue
under a burst of Zipf traffic. Runs on the card unless given ``--device
cpu``:

    PYTHONPATH=src python examples/torch/serve_embeddings.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.store import open_graph
from repro_torch.engine import WalkPlan
from repro_torch.serve import EmbeddingService, synthetic_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device

    # relabel=degree makes vertex id == degree rank: the cache admission
    # policy's hot prefix and Zipf query popularity line up by construction
    store = open_graph("wec:k=9,deg=20,seed=0,relabel=degree")  # 512 vertices
    graph = store.graph
    print(f"graph: {graph.n} vertices, {graph.m} edges, "
          f"max degree {graph.max_degree}")

    cfg = Node2VecConfig(walk_length=30, num_walks=3, dim=64, epochs=1,
                         batch_size=4096, cap=32, seed=0)
    service = EmbeddingService.from_node2vec(
        store, cfg, device=device, plan=WalkPlan(backend="reference", cap=32),
        cache_size=128, linger_s=2e-4, margin_s=1e-3)
    print(f"service resident: emb {tuple(service.emb.shape)}, "
          f"buckets {service.batcher.buckets}")

    # --- direct queries --------------------------------------------------
    hub = 0                                 # degree rank 0 == biggest hub
    e = service.embed([hub], window=0)[0]
    e_ctx = service.embed([hub], window=5)[0]       # walk-averaged context
    print(f"embed({hub}): plain vs walk-averaged cosine "
          f"{float(e @ e_ctx):.3f}")

    ids, scores = service.rank_neighbors([hub], k=5)
    print(f"rank_neighbors({hub}, k=5): {ids[0].tolist()} "
          f"scores {np.round(scores[0], 3).tolist()}")

    # --- queued serving under Zipf traffic -------------------------------
    for b in service.batcher.buckets:       # warm each bucket once
        service.embed([0] * b)
        service.rank_neighbors([0] * b, k=5)
    for ev in synthetic_trace(graph.n, 1000, alpha=1.2, qps=20_000.0,
                              seed=0):
        service.submit(ev.kind, ev.node, k=5, deadline_s=ev.deadline_s)
        service.pump()
    service.drain()

    st = service.stats()
    print(f"served {st.requests} requests in {st.batches} batches: "
          f"p50 {st.p50_latency_us:.0f}us p99 {st.p99_latency_us:.0f}us "
          f"QPS {st.qps:.0f} hit-rate {st.cache_hit_rate:.2f} "
          f"occupancy {st.batch_occupancy:.2f}")
    return {"emb": service.emb.cpu().numpy(), "ids": ids, "stats": st}


if __name__ == "__main__":
    main()
