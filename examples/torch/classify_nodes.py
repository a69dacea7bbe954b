"""Node classification (the paper's Fig. 6 experiment, end to end) — the
PyTorch port of ``examples/classify_nodes.py``.

Trains Node2Vec embeddings on a labeled community graph three ways — exact,
FN-Approx, and the Spark trim baseline — then fits a linear probe and prints
micro-F1 for each, reproducing the paper's quality ranking:
exact ≈ approx >> spark-trim. Runs on the card unless given ``--device
cpu``:

    PYTHONPATH=src python examples/torch/classify_nodes.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.node2vec import (Node2VecConfig, generate_walks,
                                       train_embeddings)
from repro_torch.data.store import open_graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device

    store = open_graph("sbm:n=400,c=4,pin=0.06,pout=0.004,seed=1")
    graph, labels = store.graph, store.labels
    rng = np.random.default_rng(0)
    graph.wgt = (rng.random(graph.m) * 4 + 0.5).astype(np.float32)
    print(f"graph: {graph.n} vertices, {graph.m} edges, 4 communities")

    def probe_accuracy(emb):
        idx = np.random.default_rng(0).permutation(graph.n)
        tr, te = idx[:graph.n // 2], idx[graph.n // 2:]
        y = np.eye(4)[labels]
        w, *_ = np.linalg.lstsq(emb[tr], y[tr], rcond=None)
        return ((emb[te] @ w).argmax(1) == labels[te]).mean()

    base = dict(p=1.0, q=0.5, walk_length=20, num_walks=4, window=5, dim=32,
                epochs=2, batch_size=4096, seed=0)

    out = {}
    for name, g, cfg in [
        ("fn_exact", graph, Node2VecConfig(mode="exact", **base)),
        ("fn_approx", graph, Node2VecConfig(mode="approx", approx_eps=5e-2,
                                            cap=16, **base)),
        ("spark_trim", graph.trim_top_weights(4),
         Node2VecConfig(mode="exact", **base)),
    ]:
        walks = generate_walks(g, cfg, device=device)
        emb = train_embeddings(g, walks, cfg, device=device)
        out[name] = (walks, probe_accuracy(emb))
        print(f"{name:12s} micro-F1 = {out[name][1]:.3f}")
    return out


if __name__ == "__main__":
    main()
