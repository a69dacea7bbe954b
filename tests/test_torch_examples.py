"""The PyTorch examples (``examples/torch/``) on the CPU against the JAX
package: each script's ``main(["--device", "cpu"])`` prints the JAX
example's deterministic lines (graphs, round stats, shapes) word for word,
and its walks equal the JAX package's for the same plans and seeds;
float results are held to stated tolerances (embeddings 2e-4 as the
trainer's tests hold them, micro-F1 0.02; the trainer itself is held in
tests/test_torch_sgns.py and tests/test_torch_train.py).
``distributed_walks.py`` runs on both ranks of a 2-process gloo world."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.node2vec import Node2VecConfig as JConfig
from repro.core.node2vec import generate_walks as j_generate_walks
from repro.core.node2vec import train_embeddings as j_train_embeddings
from repro.data import open_graph as j_open_graph
from repro.engine import WalkEngine as JEngine
from repro.engine import WalkPlan as JPlan
from repro.runtime.balance import shard_balance as j_shard_balance

from torch_world import World

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: its loops of small ops run ~20x
    slower when the test workers' thread pools oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(name: str, capsys):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    result = mod.main(["--device", "cpu"])
    return result, capsys.readouterr().out.splitlines()


def _graph_line(g) -> str:
    return (f"graph: {g.n} vertices, {g.m} edges, "
            f"max degree {g.max_degree}")


def test_quickstart_matches_jax(capsys):
    got, lines = _run("quickstart", capsys)
    g = j_open_graph("wec:k=10,deg=30,seed=0").graph
    rounds = list(JEngine.build(g, JPlan(p=1.0, q=0.5, length=40, cap=32,
                                         backend="reference")).rounds(
        4, seed=0))
    st = rounds[0].stats
    walks = np.concatenate([r.walks for r in rounds], axis=0)
    assert lines[:3] == [
        _graph_line(g),
        f"round stats: backend={st.backend} walkers={st.walkers} "
        f"supersteps={st.supersteps} dropped={st.dropped}",
        "embeddings: (1024, 64)"]
    assert np.array_equal(got["walks"], walks)
    assert got["emb"].shape == (1024, 64)
    np.testing.assert_allclose(np.linalg.norm(got["emb"], axis=1), 1.0,
                               atol=1e-5)
    hub = int(np.argmax(g.deg))
    top = re.match(rf"most similar to hub vertex {hub}: \[(.*)\]", lines[3])
    assert len(top.group(1).split(", ")) == 5
    assert lines[4].startswith("overlap with actual neighbors:")


def test_classify_nodes_matches_jax(capsys):
    got, lines = _run("classify_nodes", capsys)
    store = j_open_graph("sbm:n=400,c=4,pin=0.06,pout=0.004,seed=1")
    graph, labels = store.graph, store.labels
    graph.wgt = (np.random.default_rng(0).random(graph.m) * 4
                 + 0.5).astype(np.float32)
    assert lines[0] == f"graph: {graph.n} vertices, {graph.m} edges, " \
                       f"4 communities"
    base = dict(p=1.0, q=0.5, walk_length=20, num_walks=4, window=5,
                dim=32, epochs=2, batch_size=4096, seed=0)
    idx = np.random.default_rng(0).permutation(graph.n)
    tr, te = idx[:graph.n // 2], idx[graph.n // 2:]
    for line, (name, g, cfg) in zip(lines[1:], [
        ("fn_exact", graph, JConfig(mode="exact", **base)),
        ("fn_approx", graph, JConfig(mode="approx", approx_eps=5e-2,
                                     cap=16, **base)),
        ("spark_trim", graph.trim_top_weights(4),
         JConfig(mode="exact", **base)),
    ]):
        walks = j_generate_walks(g, cfg)
        assert np.array_equal(got[name][0], walks), name
        emb = j_train_embeddings(g, walks, cfg)
        w, *_ = np.linalg.lstsq(emb[tr], np.eye(4)[labels][tr], rcond=None)
        f1 = ((emb[te] @ w).argmax(1) == labels[te]).mean()
        assert abs(got[name][1] - f1) <= 0.02, (name, got[name][1], f1)
        assert line == f"{name:12s} micro-F1 = {got[name][1]:.3f}"


def test_serve_embeddings_matches_jax(capsys):
    from repro.core.node2vec import node2vec as j_node2vec
    got, lines = _run("serve_embeddings", capsys)
    store = j_open_graph("wec:k=9,deg=20,seed=0,relabel=degree")
    assert lines[:2] == [_graph_line(store.graph),
                         "service resident: emb (512, 64), "
                         "buckets (8, 32, 128)"]
    emb = j_node2vec(store.graph, JConfig(walk_length=30, num_walks=3,
                                          dim=64, epochs=1, batch_size=4096,
                                          cap=32, seed=0))
    np.testing.assert_allclose(got["emb"], emb, atol=2e-4, rtol=0)
    assert lines[2].startswith("embed(0): plain vs walk-averaged cosine")
    assert lines[3].startswith(f"rank_neighbors(0, k=5): "
                               f"{got['ids'][0].tolist()}")
    assert got["stats"].requests == 1000
    assert lines[4].startswith("served 1000 requests in ")


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


def test_distributed_walks_in_a_world_of_two(world, tmp_path):
    """Both ranks get the same walks, equal to the JAX package's for the
    example's plan and seeds; the resumed run (one rank) gives the first
    run's rounds; rank 0 alone prints, rank 1 nothing."""
    out = world.run("torch_world:example",
                    str(EXAMPLES / "distributed_walks.py"),
                    ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    g = j_open_graph("skew:s=3,k=10,deg=25,seed=0,relabel=degree").graph
    cfg = JConfig(p=0.5, q=2.0, walk_length=20, num_walks=3, cap=32, seed=7)
    rep = j_shard_balance(g, num_shards=8, cap=32)
    want = j_generate_walks(g, cfg)
    one = JEngine.build(g, cfg.plan()).run(seed=7).walks
    (r0, printed), (r1, quiet) = out
    assert quiet == ""
    lines = printed.splitlines()
    assert lines[:2] == [
        _graph_line(g),
        f"shard balance: raw edge imbalance {rep.edge_imbalance:.2f}x, "
        f"post-cap work imbalance {rep.capped_imbalance:.2f}x"]
    assert re.match(r"engine stats: ranks=2 dropped=0 supersteps=20 ",
                    lines[2])
    assert lines[3:] == ["round 0: (1024, 20)", "round 1: (1024, 20)",
                         "resumed on 1 of 2 ranks: 3 rounds, 1024 walks "
                         "each",
                         "fault-tolerant, elastic, deterministic: OK"]
    for res in (r0, r1):
        assert np.array_equal(res["walks"], one)
        for r, w in enumerate(res["first"]):
            assert np.array_equal(w, want[r * g.n:(r + 1) * g.n])
    assert r1["rounds"] == []
    assert np.array_equal(np.concatenate(r0["rounds"]), want)
