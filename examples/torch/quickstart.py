"""Quickstart: Fast-Node2Vec end to end in ~30 lines, through the unified
WalkEngine API — the PyTorch port of ``examples/quickstart.py``.

Loads a small social-like graph from the dataset registry (swap the spec
for ``"edgelist:/path/to/edges.txt"`` to walk a real on-disk graph),
declares a WalkPlan (FN-Cache layout, exact 2nd-order sampling), streams
FN-Multi walk rounds from the engine, trains SGNS embeddings, and prints
nearest neighbors of the highest-degree vertex in embedding space. Swap
``backend="reference"`` for ``"fused"`` (the CUDA step kernel) or
``"sharded"`` (one program per rank) — same walks, same seed. Runs on the
card unless given ``--device cpu``:

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.node2vec import Node2VecConfig, train_embeddings
from repro_torch.data.store import open_graph
from repro_torch.engine import WalkEngine, WalkPlan


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device

    store = open_graph("wec:k=10,deg=30,seed=0")         # 1024 vertices
    graph = store.graph
    print(f"graph: {graph.n} vertices, {graph.m} edges, "
          f"max degree {graph.max_degree}")

    plan = WalkPlan(
        p=1.0, q=0.5,            # DFS-ish exploration (community features)
        length=40,
        cap=32,                  # FN-Cache layout: popular rows replicated
        backend="reference")
    engine = WalkEngine.build(graph, plan, device=device)

    rounds = list(engine.rounds(4, seed=0))              # FN-Multi: 4 rounds
    stats = rounds[0].stats
    print(f"round stats: backend={stats.backend} walkers={stats.walkers} "
          f"supersteps={stats.supersteps} dropped={stats.dropped}")
    walks = np.concatenate([r.walks for r in rounds], axis=0)

    cfg = Node2VecConfig(window=5, dim=64, epochs=2, batch_size=4096, seed=0)
    emb = train_embeddings(graph, walks, cfg, device=device)
    print(f"embeddings: {emb.shape}")

    v = int(np.argmax(graph.deg))
    sims = emb @ emb[v]
    top = np.argsort(-sims)[1:6]
    print(f"most similar to hub vertex {v}: {top.tolist()}")
    print("overlap with actual neighbors:",
          len(set(top.tolist()) & set(graph.neighbors(v).tolist())), "/ 5")
    return {"walks": walks, "emb": emb}


if __name__ == "__main__":
    main()
