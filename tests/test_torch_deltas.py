"""Graph churn on the host: the port's ``data/deltas.py`` and
``GraphStore.apply`` against the JAX package's on the same seeded inputs.
Batches, CSR arrays and ``PatchReport`` fields must be equal exactly, with
and without ``relabel=degree``."""
import dataclasses

import numpy as np
import pytest

from repro.data import open_graph as j_open_graph
from repro.data.deltas import DeltaBatch as JBatch
from repro.data.deltas import apply_delta_csr as j_apply
from repro.data.deltas import weight_churn as j_weight_churn
from repro.data.deltas import zipf_churn as j_zipf_churn
from repro_torch.data.deltas import (DeltaBatch, PatchReport,
                                     apply_delta_csr, weight_churn,
                                     zipf_churn)
from repro_torch.data.store import DEFAULT_PATCH_SHARDS, open_graph

SMALL = "wec:k=8,deg=12,seed=1"                        # 256 vertices
SKEW = "skew:s=4,k=9,deg=20,seed=3,relabel=degree"     # 512, relabelled
BATCH_FIELDS = ("add_src", "add_dst", "add_wgt", "rem_src", "rem_dst")


def _same_csr(a, b):
    assert a.n == b.n
    for f, dt in (("row_ptr", np.int64), ("col", np.int32),
                  ("wgt", np.float32)):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype == dt, f
        assert np.array_equal(x, y), f


def _same_batch(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f
    assert a.base_version == b.base_version


def _same_report(a: PatchReport, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert (a.num_affected, a.delta_edges, a.shard_fraction) == \
        (b.num_affected, b.delta_edges, b.shard_fraction)


def _raw_edges(n, seed, k=24):
    """Raw add/remove lists with duplicates, self loops and repeats."""
    rng = np.random.default_rng(seed)
    s, d = rng.integers(0, n, size=k), rng.integers(0, n, size=k)
    s[:3], d[:3] = 7, 7                          # self loops
    s[3:6], d[3:6] = 4, 9                        # a duplicate, last wins
    w = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    rs, rd = rng.integers(0, n, size=k // 2), rng.integers(0, n, size=k // 2)
    return (s, d, w), (rs, rd)


@pytest.mark.parametrize("undirected", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_matches_jax(undirected, seed):
    add, rem = _raw_edges(64, seed)
    _same_batch(DeltaBatch.build(add=add, remove=rem, undirected=undirected,
                                 base_version=3),
                JBatch.build(add=add, remove=rem, undirected=undirected,
                             base_version=3))
    # weight defaults, empty sides
    _same_batch(DeltaBatch.build(add=add[:2]), JBatch.build(add=add[:2]))
    _same_batch(DeltaBatch.build(remove=rem), JBatch.build(remove=rem))
    _same_batch(DeltaBatch.build(), JBatch.build())


def test_build_rejects_what_jax_rejects():
    for bad in (0.0, -1.0, np.nan, np.inf):
        with pytest.raises(ValueError, match="finite and > 0"):
            DeltaBatch.build(add=([0, 1], [2, 3], [1.0, bad]))
    with pytest.raises(ValueError, match="length mismatch"):
        DeltaBatch.build(add=([0, 1], [2]))
    b = DeltaBatch.build(add=([0], [63]))
    b.check(64)
    with pytest.raises(ValueError, match="outside"):
        b.check(63)


def test_remap_matches_jax():
    add, rem = _raw_edges(512, 5)
    perm = np.random.default_rng(2).permutation(512)
    _same_batch(DeltaBatch.build(add=add, remove=rem).remap(perm),
                JBatch.build(add=add, remove=rem).remap(perm))


@pytest.mark.parametrize("spec", [SMALL, SKEW])
def test_churn_streams_match_jax(spec):
    g, jg = open_graph(spec).graph, j_open_graph(spec).graph
    for kw in (dict(num_batches=3, batch_edges=12, seed=4),
               dict(num_batches=2, batch_edges=9, seed=1, alpha=1.3,
                    add_fraction=0.7, weight_updates=False),
               dict(num_batches=2, batch_edges=10, seed=5, top=32),
               # the removal pool drains: re-adds of removed edges
               dict(num_batches=3, batch_edges=400, seed=9, top=48,
                    weight_updates=False)):
        got, want = list(zipf_churn(g, **kw)), list(j_zipf_churn(jg, **kw))
        assert len(got) == len(want) == kw["num_batches"]
        for a, b in zip(got, want):
            _same_batch(a, b)
    for kw in (dict(num_batches=3, batch_edges=16, seed=2),
               dict(num_batches=2, batch_edges=8, seed=3, alpha=0.8,
                    top=40)):
        got = list(weight_churn(g, **kw))
        want = list(j_weight_churn(jg, **kw))
        for a, b in zip(got, want):
            _same_batch(a, b)


def test_churn_from_an_empty_pool_matches_jax():
    """No edge joins the candidates at first: removals draw only from the
    stream's own additions."""
    from repro.core.graph import CSRGraph as JGraph
    from repro_torch.core.graph import CSRGraph
    src, dst = np.array([0, 1, 2, 3, 0, 1, 2, 3]), np.array([4, 5, 6, 7,
                                                             5, 6, 7, 4])
    got = list(zipf_churn(CSRGraph.from_edges(8, src, dst), 2, 6, seed=1,
                          top=4))
    want = list(j_zipf_churn(JGraph.from_edges(8, src, dst), 2, 6, seed=1,
                             top=4))
    for a, b in zip(got, want):
        _same_batch(a, b)
    assert got[0].num_remove > 0


@pytest.mark.parametrize("spec", [SMALL, SKEW])
def test_store_apply_matches_jax(spec):
    """Mixed churn (inserts, removals, weight bumps) through both stores:
    the same CSR arrays, reports and versions after every batch; under
    relabel=degree both map the original ids through the frozen perm."""
    st, jst = open_graph(spec), j_open_graph(spec)
    assert st.num_shards == jst.num_shards == DEFAULT_PATCH_SHARDS
    assert (st.perm is None) == (jst.perm is None)
    batches = list(j_zipf_churn(j_open_graph(spec.split(",relabel")[0])
                                .graph, num_batches=4, batch_edges=12,
                                seed=6))
    mine = [DeltaBatch(**{f: getattr(b, f) for f in BATCH_FIELDS})
            for b in batches]
    _same_report(st.apply(mine[0]), jst.apply(batches[0]))
    _same_csr(st.graph, jst.graph)
    rep, jrep = st.apply(mine[1:]), jst.apply(batches[1:])   # merged
    _same_report(rep, jrep)
    _same_report(st.last_report, jst.last_report)
    _same_csr(st.graph, jst.graph)
    assert st.version == jst.version == 4


@pytest.mark.parametrize("num_shards", [1, 7, 64])
@pytest.mark.parametrize("seed", [0, 3])
def test_apply_delta_csr_matches_jax(num_shards, seed):
    """Random batches on independent copies: removals of real edges, adds
    that mix inserts and weight bumps; in place where counts are conserved
    and out of place otherwise, both as the JAX package decides."""
    g, jg = open_graph(SMALL).graph, j_open_graph(SMALL).graph
    rng = np.random.default_rng(seed)
    for _ in range(2):
        e = rng.choice(g.m, size=15, replace=False)
        rem = (np.searchsorted(g.row_ptr, e, side="right") - 1,
               g.col[e].astype(np.int64))
        add = (rng.integers(0, g.n, size=20), rng.integers(0, g.n, size=20),
               rng.uniform(0.5, 2.0, size=20).astype(np.float32))
        g, rep = apply_delta_csr(g, DeltaBatch.build(add=add, remove=rem),
                                 num_shards=num_shards)
        jg, jrep = j_apply(jg, JBatch.build(add=add, remove=rem),
                           num_shards=num_shards)
        _same_report(rep, jrep)
        _same_csr(g, jg)


@pytest.mark.parametrize("allow_in_place", [True, False])
def test_weight_only_batches_in_place_as_jax(allow_in_place):
    g, jg = open_graph(SMALL).graph, j_open_graph(SMALL).graph
    for b in list(weight_churn(g, num_batches=2, batch_edges=10, seed=4)):
        col = g.col
        g, rep = apply_delta_csr(g, b, allow_in_place=allow_in_place)
        jg, jrep = j_apply(jg, JBatch(**{f: getattr(b, f)
                                         for f in BATCH_FIELDS}),
                           allow_in_place=allow_in_place)
        _same_report(rep, jrep)
        _same_csr(g, jg)
        assert rep.in_place == allow_in_place
        assert (g.col is col) == allow_in_place


def test_empty_batch_is_identity():
    g = open_graph(SMALL).graph
    out, rep = apply_delta_csr(g, DeltaBatch.build())
    jg = j_open_graph(SMALL).graph
    _, jrep = j_apply(jg, JBatch.build())
    assert out is g
    _same_report(rep, jrep)


def test_store_rejects_stale_batches_and_save():
    st = open_graph(SMALL)
    st.apply(DeltaBatch.build(add=([0], [5]), base_version=0))
    with pytest.raises(ValueError, match="stale"):
        st.apply(DeltaBatch.build(add=([1], [6]), base_version=0))
    with pytest.raises(ValueError, match="at least one"):
        st.apply([])
    with pytest.raises(TypeError, match="DeltaBatch"):
        st.apply([("not", "a batch")])
    assert st.version == 1
    with pytest.raises(NotImplementedError, match="item 6"):
        st.save("unused")
