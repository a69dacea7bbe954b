"""Graph-embedding serving launcher — port of ``repro.launch.serve_graph``
(``launch/serve.py`` serves the LM side).

Dataset spec -> walks -> SGNS embeddings -> resident
:class:`~repro_torch.serve.EmbeddingService` -> synthetic Zipf traffic
replayed against the real clock -> a ``ServeStats`` report (p50/p99
latency, QPS, cache hit rate, batch occupancy). Runs on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve_graph --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --full \\
      --graph "rmat:k=14,deg=16,relabel=degree" --requests 20000 --alpha 1.2
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.engine import WalkPlan
from repro_torch.serve import EmbeddingService, ServeStats, synthetic_trace


def build_service(args) -> EmbeddingService:
    store = open_graph(args.graph)
    g = store.graph
    print(f"graph: {args.graph} -> n={g.n} m={g.m} maxdeg={g.max_degree}")
    cfg = Node2VecConfig(walk_length=args.walk_length, num_walks=args.rounds,
                         dim=args.dim, epochs=1, batch_size=4096,
                         cap=args.cap, seed=args.seed)
    t0 = time.time()
    svc = EmbeddingService.from_node2vec(
        store, cfg, device=args.device,
        plan=WalkPlan(backend="reference", cap=args.cap),
        cache_size=args.cache_size, linger_s=args.linger_ms * 1e-3,
        margin_s=args.margin_ms * 1e-3, walk_seed=args.seed)
    print(f"walk+SGNS+residency build: {time.time() - t0:.1f}s "
          f"(dim={args.dim}, cache={args.cache_size}, device={svc.device})")
    return svc


def replay(svc: EmbeddingService, args) -> ServeStats:
    trace = synthetic_trace(svc.graph.n, args.requests, alpha=args.alpha,
                            rank_share=args.rank_share, qps=args.qps,
                            deadline_s=args.deadline_ms * 1e-3,
                            seed=args.seed)
    # warm every bucket first, so expiries mean real starvation and not
    # first-call costs
    for b in svc.batcher.buckets:
        nodes = [0] * b
        svc.embed(nodes, window=0)
        if args.window:
            svc.embed(nodes, window=args.window)
        svc.rank_neighbors(nodes, args.k)
    t0 = time.time()
    for ev in trace:
        svc.submit(ev.kind, ev.node, window=args.window, k=args.k,
                   deadline_s=ev.deadline_s)
        svc.pump()
    svc.drain()
    wall = time.time() - t0
    st = svc.stats()
    print(f"\ntrace: {args.requests} reqs, zipf a={args.alpha}, "
          f"rank share {args.rank_share:.0%}, deadline "
          f"{args.deadline_ms:.0f}ms, wall {wall:.2f}s")
    print(f"{'metric':<22}{'value':>14}")
    for name, val in [
        ("requests", f"{st.requests}"),
        ("expired", f"{st.expired}"),
        ("batches", f"{st.batches}"),
        ("p50 latency (us)", f"{st.p50_latency_us:.0f}"),
        ("p99 latency (us)", f"{st.p99_latency_us:.0f}"),
        ("QPS", f"{st.qps:.0f}"),
        ("cache hit rate", f"{st.cache_hit_rate:.3f}"),
        ("batch occupancy", f"{st.batch_occupancy:.3f}"),
    ]:
        print(f"{name:<22}{val:>14}")
    if st.requests + st.expired < args.requests:
        raise SystemExit("lost responses: "
                         f"{st.requests + st.expired} < {args.requests}")
    return st


def main(argv=None) -> ServeStats:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="small graph + short trace (default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--graph", default=None,
                    help="dataset spec (repro_torch.data.ingest registry)")
    ap.add_argument("--dim", type=int, default=None)
    ap.add_argument("--cap", type=int, default=32,
                    help="FN-Cache cold row width (hot set = deg > cap)")
    ap.add_argument("--walk-length", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--alpha", type=float, default=1.2,
                    help="Zipf exponent of query popularity")
    ap.add_argument("--rank-share", type=float, default=0.5)
    ap.add_argument("--qps", type=float, default=20_000.0,
                    help="trace arrival rate (closed-loop replay)")
    ap.add_argument("--deadline-ms", type=float, default=50.0)
    ap.add_argument("--window", type=int, default=0,
                    help="walk-averaged embed context window (0 = gather)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cache-size", type=int, default=512)
    ap.add_argument("--linger-ms", type=float, default=0.2)
    ap.add_argument("--margin-ms", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.graph is None:
        args.graph = ("skew:s=4,k=9,deg=20,seed=3,relabel=degree"
                      if args.smoke else
                      "rmat:k=16,deg=16,seed=0,relabel=degree")
    if args.dim is None:
        args.dim = 64 if args.smoke else 128
    if args.requests is None:
        args.requests = 2000 if args.smoke else 50_000
    args.device = resolve_device(args.device)

    svc = build_service(args)
    return replay(svc, args)


if __name__ == "__main__":
    main()
