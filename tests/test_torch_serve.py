"""Graph-embedding serving: the port's ``serve/`` and
``launch/serve_graph`` against the JAX package's ``repro.serve`` on the
same graph, table and trace. Integer outputs (trace events, rank ids, LRU
order, admission, batch and expiry counts, refresh reports, warm counts)
must be equal; embeddings within 1e-6, rank scores within 1e-5."""
import dataclasses

import numpy as np
import pytest

from repro.data import open_graph as j_open_graph
from repro.data.deltas import DeltaBatch as JBatch
from repro.engine import WalkPlan as JPlan
from repro.serve import EmbeddingService as JService
from repro.serve import VirtualClock as JClock
from repro.serve import synthetic_trace as j_synthetic_trace
from repro.serve import zipf_nodes as j_zipf_nodes
from repro_torch.data.deltas import DeltaBatch
from repro_torch.engine import WalkPlan
from repro_torch.serve import (DeadlineBatcher, EmbeddingService,
                               ResultCache, VirtualClock, synthetic_trace,
                               zipf_nodes)

SKEW = "skew:s=4,k=9,deg=20,seed=3,relabel=degree"     # 512, relabelled
SMALL = "wec:k=8,deg=12,seed=1"                        # 256 vertices
CAP = 24
EMB_TOL = 1e-6
SCORE_TOL = 1e-5


def _emb(n, dim=16, seed=0):
    e = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _pair(spec=SKEW, emb=None, backend="reference", **kw):
    """A port service and a JAX service over the same graph and table."""
    kw.setdefault("cache_size", 64)
    kw.setdefault("buckets", (4, 16, 64))
    cap = kw.pop("cap", CAP)
    length = kw.pop("length", 80)
    emb = _emb(j_open_graph(spec).graph.n) if emb is None else emb
    clock, jclock = VirtualClock(), JClock()
    svc = EmbeddingService(spec, emb, plan=WalkPlan(
        backend=backend, cap=cap, length=length), clock=clock,
        device="cpu", **kw)
    jsvc = JService(spec, emb, plan=JPlan(backend="reference", cap=cap,
                                          length=length), clock=jclock, **kw)
    return svc, jsvc, clock, jclock


def _close_value(a, b):
    if isinstance(a, tuple):
        assert np.array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=SCORE_TOL)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=EMB_TOL)


def test_trace_matches_jax():
    for kw in (dict(alpha=1.2, rank_share=0.5, qps=20_000.0, seed=0),
               dict(alpha=1.1, rank_share=0.3, qps=5_000.0, deadline_s=0.01,
                    seed=4)):
        got = [dataclasses.astuple(e) for e in synthetic_trace(512, 400,
                                                                **kw)]
        assert got == [dataclasses.astuple(e)
                       for e in j_synthetic_trace(512, 400, **kw)]
    assert np.array_equal(zipf_nodes(1000, 300, alpha=1.3, seed=2),
                          j_zipf_nodes(1000, 300, alpha=1.3, seed=2))


@pytest.mark.parametrize("window", [0, 3])
def test_embed_matches_jax(window):
    svc, jsvc, _, _ = _pair()
    nodes = zipf_nodes(svc.graph.n, 40, alpha=1.1, seed=7)
    got = svc.embed(nodes, window=window)
    want = jsvc.embed(nodes, window=window)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)


def test_fused_service_equals_reference():
    """Walk windows on the fused backend (the step kernel's plain version
    on the CPU) give the reference backend's embeddings bit for bit."""
    fused, _, _, _ = _pair(backend="fused")
    ref, _, _, _ = _pair()
    nodes = zipf_nodes(ref.graph.n, 40, alpha=1.1, seed=3)
    assert np.array_equal(fused.embed(nodes, window=5),
                          ref.embed(nodes, window=5))


@pytest.mark.parametrize("scope,k", [("neighbors", 6), ("neighbors", 200),
                                     ("all", 9)])
def test_rank_matches_jax(scope, k):
    """k=200 exceeds the widest candidate row: -inf / -1 padding."""
    svc, jsvc, _, _ = _pair()
    nodes = np.concatenate([[0, 1, svc.graph.n - 1],
                            zipf_nodes(svc.graph.n, 30, seed=1)])
    ids, sc = svc.rank_neighbors(nodes, k, scope=scope)
    jids, jsc = jsvc.rank_neighbors(nodes, k, scope=scope)
    assert ids.dtype == jids.dtype == np.int32
    assert np.array_equal(ids, jids)
    finite = np.isfinite(jsc)
    assert np.array_equal(np.isfinite(sc), finite)
    np.testing.assert_allclose(sc[finite], jsc[finite], rtol=0,
                               atol=SCORE_TOL)
    if k == 200:
        assert (ids == -1).any()


@pytest.mark.parametrize("scope", ["neighbors", "all"])
def test_rank_ties_take_the_lower_index(scope):
    """Duplicate embedding rows give equal scores; both packages list the
    lower candidate index first (jax.lax.top_k's rule)."""
    g = j_open_graph(SKEW).graph
    emb = _emb(g.n, dim=8, seed=5)
    emb[1::2] = emb[0::2]                # rows 2i and 2i+1 equal
    svc, jsvc, _, _ = _pair(emb=emb)
    nodes = np.arange(40, dtype=np.int32) * 7
    ids, sc = svc.rank_neighbors(nodes, 12, scope=scope)
    jids, jsc = jsvc.rank_neighbors(nodes, 12, scope=scope)
    assert np.array_equal(ids, jids)
    np.testing.assert_allclose(sc, jsc, rtol=0, atol=SCORE_TOL)
    ties = (sc[:, 1:] == sc[:, :-1]) & np.isfinite(sc[:, 1:])
    assert ties.any()
    assert (ids[:, 1:][ties] > ids[:, :-1][ties]).all()


def test_batched_matches_single():
    svc, _, _, _ = _pair()
    nodes = zipf_nodes(svc.graph.n, 20, alpha=1.1, seed=7)
    for window in (0, 4):
        batched = svc.embed(nodes, window=window)
        singles = np.stack([svc.embed(int(v), window=window)[0]
                            for v in nodes])
        assert np.array_equal(batched, singles)
    ids_b, sc_b = svc.rank_neighbors(nodes, k=6)
    for i, v in enumerate(nodes):
        ids_s, sc_s = svc.rank_neighbors(int(v), k=6)
        assert np.array_equal(ids_b[i], ids_s[0])
        assert np.array_equal(sc_b[i], sc_s[0])


def test_replay_matches_jax():
    """A Zipf trace replayed on virtual clocks through both services: the
    same responses (ids, expiry), values within tolerance, the same LRU
    order, admissions, hit rate, occupancy, batch and expiry counts, and
    compile-shape sets."""
    svc, jsvc, clock, jclock = _pair(linger_s=2e-4, margin_s=1e-3,
                                     length=80)
    trace = synthetic_trace(svc.graph.n, 300, alpha=1.2, qps=10_000.0,
                            deadline_s=0.002, seed=0)
    got, want = [], []
    for i, ev in enumerate(trace):
        for c in (clock, jclock):
            c.t = ev.t_arrival + (0.005 if i % 50 == 49 else 0.0)
        kw = dict(window=2 if i % 3 else 0, k=5, deadline_s=ev.deadline_s)
        assert svc.submit(ev.kind, ev.node, now=clock(), **kw) == \
            jsvc.submit(ev.kind, ev.node, now=jclock(), **kw)
        got += svc.pump(now=clock())
        want += jsvc.pump(now=jclock())
    got += svc.drain(now=clock() + 1.0)
    want += jsvc.drain(now=jclock() + 1.0)
    assert [(r.rid, r.expired, r.t_submit, r.t_done) for r in got] == \
        [(r.rid, r.expired, r.t_submit, r.t_done) for r in want]
    for a, b in zip(got, want):
        if not a.expired:
            _close_value(a.value, b.value)
    assert svc.cache.keys() == jsvc.cache.keys()
    assert (svc.cache.hits, svc.cache.misses) == \
        (jsvc.cache.hits, jsvc.cache.misses)
    st, jst = svc.stats(), jsvc.stats()
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.requests + st.expired == 300 and st.expired > 0
    assert 0.0 < st.cache_hit_rate < 1.0
    assert svc.compiled_shapes == jsvc.compiled_shapes


def test_cold_queries_never_evict_hot_as_jax():
    svc, jsvc, clock, jclock = _pair(cache_size=4)
    for s, c in ((svc, clock), (jsvc, jclock)):
        for v in [0, 1, 2, 3] + list(range(s.graph.n - 32, s.graph.n)):
            s.submit("embed", v, now=c())
            s.drain(now=c())
    assert svc.cache.keys() == jsvc.cache.keys()
    assert sorted(k[1] for k in svc.cache.keys()) == [0, 1, 2, 3]


def test_deadline_expiry_and_lru_order():
    c = ResultCache(3)
    for k in "abc":
        c.put(k, k.upper(), node=0)
    c.get("a")
    c.put("d", "D", node=0)
    assert c.keys() == ["c", "a", "d"]
    b = DeadlineBatcher(buckets=(4, 16), linger_s=10.0, margin_s=1e-3)
    b.submit(("embed", 0), 1, deadline=100.0, now=0.0)
    assert b.due(now=0.0) == []
    b.submit(("embed", 0), 2, deadline=0.5, now=0.1)
    (group, live, dead), = b.due(now=0.5)
    assert [r.node for r in live] == [1, 2] and dead == []


def test_refresh_matches_jax_and_a_fresh_service():
    """refresh() on a weight churn of a hub's edges: the same report dict
    as the JAX package's, affected entries dropped and bystanders kept,
    walk-window embeddings equal to a service built fresh at the new
    version (bit for bit) and within 1e-6 of JAX's refreshed service."""
    g = j_open_graph(SMALL).graph
    emb = _emb(g.n)
    kw = dict(cap=16, length=4, cache_size=64, admission=f"prefix:{g.n}")
    svc, jsvc, clock, jclock = _pair(SMALL, emb=emb, **kw)
    hub = int(np.argmax(g.deg))
    nb = g.neighbors(hub)[:2].astype(np.int64)
    bystander = next(u for u in range(g.n)
                     if u not in {hub} | set(nb.tolist()))
    for s, c in ((svc, clock), (jsvc, jclock)):
        for node in (hub, bystander):
            s.submit("embed", node, window=0, now=c())
        s.drain(now=c())
    add = (np.full(2, hub), nb, np.full(2, 3.3, np.float32))
    rep = svc.refresh(DeltaBatch.build(add=add))
    assert rep == jsvc.refresh(JBatch.build(add=add))
    assert rep["version"] == 1 and not rep["relayout"]
    assert rep["cache_entries_dropped"] >= 1
    assert svc.cache.get(("embed", hub, 0)) is None
    assert svc.cache.get(("embed", bystander, 0)) is not None
    # a relayout batch: a cold vertex grown past cap
    v = int(np.argmin(g.deg))
    fresh_nb = [u for u in range(g.n)
                if u != v and u not in set(g.neighbors(v).tolist())][:20]
    add2 = (np.full(len(fresh_nb), v), fresh_nb)
    rep2 = svc.refresh(DeltaBatch.build(add=add2))
    assert rep2 == jsvc.refresh(JBatch.build(add=add2))
    assert rep2["relayout"]
    nodes = [hub, bystander, v, 3, 200]
    fresh, _, _, _ = _pair(SMALL, emb=emb, **kw)
    fresh.refresh([DeltaBatch.build(add=add), DeltaBatch.build(add=add2)])
    got = svc.embed(nodes, window=3)
    assert np.array_equal(got, fresh.embed(nodes, window=3))
    np.testing.assert_allclose(got, jsvc.embed(nodes, window=3), rtol=0,
                               atol=EMB_TOL)


def test_warm_from_walks_matches_jax():
    for top, window in ((None, 0), (5, 2)):
        svc, jsvc, _, _ = _pair(cache_size=32)
        walks = zipf_nodes(svc.graph.n, 320, alpha=1.2, seed=3).reshape(40, 8)
        warmed = svc.warm_from_walks(walks, window=window, top=top)
        assert warmed == jsvc.warm_from_walks(walks, window=window, top=top)
        assert 0 < warmed <= (32 if top is None else top)
        assert svc.cache.keys() == jsvc.cache.keys()
        for key in svc.cache.keys():
            _close_value(svc.cache.get(key), jsvc.cache.get(key))


def test_compile_shape_bound():
    svc, _, _, _ = _pair(buckets=(4, 16))
    rng = np.random.default_rng(0)
    for size in rng.integers(1, 17, size=12):
        svc.embed(rng.integers(0, svc.graph.n, size=size))
        svc.rank_neighbors(rng.integers(0, svc.graph.n, size=size), k=5)
    assert {s[0] for s in svc.compiled_shapes} == {"gather", "rank"}
    assert len(svc.compiled_shapes) <= 2 * len(svc.batcher.buckets)
    assert {s[1] for s in svc.compiled_shapes} <= set(svc.batcher.buckets)


def test_accepts_raw_sgns_params():
    from repro_torch import random as jr
    from repro_torch.core.skipgram import (SGNSConfig, init_params,
                                           serving_table)
    g = j_open_graph(SKEW).graph
    params = init_params(SGNSConfig(vocab=g.n, dim=8),
                         jr.PRNGKey(0, device="cpu"))
    svc = EmbeddingService(SKEW, params, plan=WalkPlan(cap=CAP),
                           device="cpu")
    assert np.array_equal(svc.emb.numpy(), serving_table(params))
    np.testing.assert_allclose(np.linalg.norm(svc.emb.numpy(), axis=1), 1.0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="emb must be"):
        EmbeddingService(SKEW, np.zeros((3, 4), np.float32), device="cpu")


def test_serve_graph_main_on_cpu(capsys):
    from repro_torch.launch import serve_graph
    st = serve_graph.main(["--device", "cpu", "--smoke", "--requests", "150",
                           "--walk-length", "5", "--rounds", "1", "--dim",
                           "16", "--window", "3"])
    assert st.requests + st.expired == 150
    assert 0.0 < st.cache_hit_rate < 1.0 and st.batches > 0
    out = capsys.readouterr().out
    assert "p99 latency (us)" in out and "device=cpu" in out
