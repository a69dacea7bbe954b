"""On-disk graph ingestion: the port's ``data/ingest.py`` (edge-list
parsing, the chunked CSR builder, the memmapped CSR cache, the cached
``edgelist:`` load) and ``GraphStore.save`` / ``open_graph("csr:...")``
against the JAX package's on the same inputs. CSR arrays, cache files and
cache keys must be equal exactly, and a cache either package writes must
load in the other."""
import os
import tracemalloc

import numpy as np
import pytest

from repro.core.graph import CSRGraph as JCSRGraph
from repro.data import ingest as jingest
from repro.data.deltas import DeltaBatch as JBatch
from repro.data.store import open_graph as j_open_graph
from repro_torch.core.graph import CSRGraph
from repro_torch.data import ingest
from repro_torch.data.deltas import DeltaBatch
from repro_torch.data.ingest import (csr_from_chunks, edgelist_to_csr,
                                     load_csr, save_csr, write_edgelist)
from repro_torch.data.store import open_graph


def _pair_weights(src, dst):
    """One weight per undirected pair, so dedup order cannot change which
    weight survives (as tests/test_ingest.py)."""
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    return ((lo * 31 + hi) % 97 + 1).astype(np.float32)


def _random_edges(n, m, seed, pair_weights=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    wgt = _pair_weights(src, dst) if pair_weights else \
        rng.uniform(0.5, 2.0, m).astype(np.float32)
    return src, dst, wgt


def _chunks_of(src, dst, wgt, chunk):
    def chunks():
        for i in range(0, len(src), chunk):
            yield (src[i:i + chunk].astype(np.int64),
                   dst[i:i + chunk].astype(np.int64), wgt[i:i + chunk])
    return chunks


def _same_csr(a, b):
    assert a.n == b.n
    for f, dt in (("row_ptr", np.int64), ("col", np.int32),
                  ("wgt", np.float32)):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype == dt, f
        assert np.array_equal(x, y), f


# ------------------------------------------------------------ builder --
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("n,m,chunk,seed", [
    (2, 1, 4, 0), (16, 40, 7, 1), (100, 1000, 64, 2), (300, 4000, 513, 3),
    (50, 5000, 4096, 4), (None, 700, 33, 5)])
def test_chunk_builder_matches_jax(n, m, chunk, seed, directed, dedup):
    """Conflicting weights too: both builders keep the first-arriving one
    in the same chunk order."""
    src, dst, wgt = _random_edges(n or 90, m, seed, pair_weights=False)
    kw = dict(n=n, undirected=not directed, dedup=dedup, block_edges=chunk)
    got = csr_from_chunks(_chunks_of(src, dst, wgt, chunk), **kw)
    want = jingest.csr_from_chunks(_chunks_of(src, dst, wgt, chunk), **kw)
    _same_csr(got, want)


def test_chunk_builder_rejects_out_of_range_ids():
    src, dst = np.array([0, 9]), np.array([1, 2])
    with pytest.raises(ValueError, match=">= n"):
        csr_from_chunks(_chunks_of(src, dst, np.ones(2, np.float32), 8), n=4)


def test_chunk_builder_peak_memory_bounded():
    """Peak transient allocation is O(n + chunk) beyond the CSR output:
    the budget is below any O(m) int32 temporary (tests/test_ingest.py's
    bound)."""
    n, m, chunk = 50_000, 1_000_000, 16_384
    rng = np.random.default_rng(7)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    chunks = _chunks_of(src, dst, np.ones(m, np.float32), chunk)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        g = csr_from_chunks(chunks, n=n, block_edges=chunk)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    m_placed = 2 * int((src != dst).sum())
    out_bytes = (n + 1) * 8 + m_placed * (4 + 4)
    budget = 24 * 8 * chunk + 32 * n + (1 << 20)
    assert budget < m_placed * 4
    assert peak - out_bytes < budget, (
        f"peak {peak / 2**20:.1f} MiB exceeds the CSR output "
        f"{out_bytes / 2**20:.1f} MiB + O(n + chunk) budget "
        f"{budget / 2**20:.1f} MiB")
    assert g.m <= m_placed


# -------------------------------------------------- text parsing + IO --
def test_edgelist_text_parsing_matches_jax(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text("# comment\n% other comment\n// third kind\n"
                 "0 1 2.5\n1,2,3.5\n\n  2 0\n3\t1\t0.25\n1 1 9\n")
    for kw in (dict(n=4), dict(), dict(undirected=False),
               dict(dedup=False, chunk_edges=2)):
        g = edgelist_to_csr(str(p), **kw)
        _same_csr(g, jingest.edgelist_to_csr(str(p), **kw))
    g = edgelist_to_csr(str(p), n=4)
    assert g.m == 8                               # the self loop dropped
    assert g.weights(0).tolist() == [2.5, 1.0]    # 0-1 weighted, 2-0 not
    assert g.neighbors(1).tolist() == [0, 2, 3]
    chunks = list(ingest.iter_edgelist_chunks(str(p), chunk_edges=2))
    want = list(jingest.iter_edgelist_chunks(str(p), chunk_edges=2))
    assert len(chunks) == len(want) == 3
    for a, b in zip(chunks, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("weighted", [True, False])
def test_write_edgelist_roundtrip(tmp_path, weighted):
    src, dst, wgt = _random_edges(200, 3000, 11)
    w = wgt if weighted else None
    write_edgelist(str(tmp_path / "port.txt"), src, dst, w)
    jingest.write_edgelist(str(tmp_path / "jax.txt"), src, dst, w)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    g = edgelist_to_csr(str(tmp_path / "port.txt"), n=200, chunk_edges=997)
    _same_csr(g, CSRGraph.from_edges(200, src, dst, w))


# -------------------------------------------------------------- cache --
def test_csr_cache_roundtrip_is_memmap_and_crosses_packages(tmp_path):
    src, dst, wgt = _random_edges(256, 3000, 1)
    g = CSRGraph.from_edges(256, src, dst, wgt)
    jg = JCSRGraph.from_edges(256, src, dst, wgt)
    d = save_csr(g, str(tmp_path / "port"), graph_version=3)
    jd = jingest.save_csr(jg, str(tmp_path / "jax"), graph_version=3)
    for f in ("indptr.npy", "col.npy", "wgt.npy", "meta.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    assert ingest.csr_meta(d) == jingest.csr_meta(jd)
    loaded = load_csr(d)
    assert isinstance(loaded.col, np.memmap)
    assert isinstance(loaded.row_ptr, np.memmap)
    _same_csr(loaded, g)
    _same_csr(load_csr(jd), jg)                 # JAX's cache in the port
    _same_csr(jingest.load_csr(d), g)           # the port's in JAX
    eager = load_csr(d, mmap=False)
    assert not isinstance(eager.col, np.memmap)
    _same_csr(eager, g)


def test_csr_cache_version_check(tmp_path):
    g = CSRGraph.from_edges(4, np.array([0, 1]), np.array([1, 2]))
    d = save_csr(g, str(tmp_path / "c"))
    meta = os.path.join(d, "meta.json")
    with open(meta) as f:
        text = f.read()
    with open(meta, "w") as f:
        f.write(text.replace(f'"version": {ingest.CSR_FORMAT_VERSION}',
                             '"version": 0'))
    with pytest.raises(ValueError, match="version"):
        load_csr(d)


@pytest.mark.parametrize("opts", [{}, {"n": "64"}, {"relabel": "degree"},
                                  {"directed": "1", "dedup": "0",
                                   "chunk": "7"}])
@pytest.mark.parametrize("graph_version", [0, 2])
def test_edgelist_cache_key_matches_jax(tmp_path, opts, graph_version):
    p = tmp_path / "e.txt"
    p.write_text("0 1\n1 2\n")
    assert ingest._edgelist_cache_key(str(p), opts, graph_version) == \
        jingest._edgelist_cache_key(str(p), opts, graph_version)


def test_cached_relabelled_load_matches_jax_and_hits(tmp_path, monkeypatch):
    src, dst, wgt = _random_edges(64, 500, 21)
    path = tmp_path / "e.txt"
    write_edgelist(str(path), src, dst, wgt)
    spec = f"edgelist:{path},n=64,relabel=degree"
    cache, jcache = str(tmp_path / "cache"), str(tmp_path / "jcache")
    first = open_graph(spec, cache_dir=cache)
    want = j_open_graph(spec, cache_dir=jcache)
    assert os.listdir(cache) == os.listdir(jcache)     # same key, same name
    _same_csr(first.graph, want.graph)
    assert np.array_equal(first.perm, want.perm)
    mem = open_graph(spec)                             # no cache
    _same_csr(mem.graph, first.graph)
    assert np.array_equal(mem.perm, first.perm)

    def no_build(*a, **k):
        raise AssertionError("the cached open rebuilt the graph")
    monkeypatch.setattr(ingest, "edgelist_to_csr", no_build)
    monkeypatch.setattr(ingest, "relabel_by_degree", no_build)
    again = open_graph(spec, cache_dir=cache)
    assert isinstance(again.graph.col, np.memmap)
    assert isinstance(again.graph.row_ptr, np.memmap)
    _same_csr(again.graph, want.graph)
    assert np.array_equal(again.perm, want.perm)
    # the JAX package's cache loads in the port too
    monkeypatch.undo()
    _same_csr(open_graph(spec, cache_dir=jcache).graph, want.graph)
    # relabelled and plain specs cache to distinct entries
    open_graph(f"edgelist:{path},n=64", cache_dir=cache)
    assert len(os.listdir(cache)) == 2


def test_spec_errors_match_jax(tmp_path):
    for spec in ("edgelist:/tmp/x.txt,cap=4", "csr:/tmp/x,n=3"):
        with pytest.raises(ValueError, match="unknown option"):
            open_graph(spec)
    with pytest.raises(ValueError, match="needs a path"):
        open_graph("edgelist:n=4")
    with pytest.raises(ValueError, match="needs a path"):
        open_graph("edgelist:n=4", cache_dir=str(tmp_path))
    with pytest.raises(ValueError, match="needs a directory"):
        open_graph("csr:mmap=0")


# ------------------------------------------------------ store + save --
def test_store_save_reopens_at_version_with_perm_and_labels(tmp_path):
    spec = "sbm:n=120,c=3,pin=0.1,pout=0.01,seed=0,relabel=degree"
    batches = [((np.array([0, 5]), np.array([9, 17])), (np.array([1]),
                                                        np.array([2])))]
    st, jst = open_graph(spec), j_open_graph(spec)
    for add, rem in batches:
        st.apply(DeltaBatch.build(add=add, remove=rem))
        jst.apply(JBatch.build(add=add, remove=rem))
    st.save(str(tmp_path / "port"))
    jst.save(str(tmp_path / "jax"))
    for f in ("indptr.npy", "col.npy", "wgt.npy", "meta.json", "perm.npy",
              "labels.npy"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    back = open_graph(f"csr:{tmp_path / 'port'}")
    jback = j_open_graph(f"csr:{tmp_path / 'jax'}")
    assert back.version == jback.version == 1
    _same_csr(back.graph, jback.graph)
    assert np.array_equal(back.perm, jback.perm)
    assert np.array_equal(back.labels, jback.labels)
    assert np.array_equal(back.labels, st.labels)
    # deltas after the reopen keep mapping through the saved perm
    more = (np.array([3]), np.array([40]))
    back.apply(DeltaBatch.build(add=more))
    jback.apply(JBatch.build(add=more))
    _same_csr(back.graph, jback.graph)
    assert back.version == 2


@pytest.mark.parametrize("kind", ["reweight", "topology"])
def test_apply_on_memmap_store_matches_jax(tmp_path, kind):
    """A cache-backed (read-only memmap) store patches out of place: the
    mapped files stay as they were, the result equals JAX's."""
    src, dst, wgt = _random_edges(64, 500, 3)
    path = tmp_path / "e.txt"
    write_edgelist(str(path), src, dst, wgt)
    spec = f"edgelist:{path},n=64,relabel=degree"
    cache = str(tmp_path / "cache")
    st = open_graph(spec, cache_dir=cache)
    jst = j_open_graph(spec, cache_dir=str(tmp_path / "jcache"))
    sub = os.path.join(cache, os.listdir(cache)[0])
    before = {f: open(os.path.join(sub, f), "rb").read()
              for f in os.listdir(sub)}
    assert not st.graph.col.flags.writeable
    if kind == "reweight":         # an existing edge: conserves the sizes
        s, d = int(src[0]), int(dst[0])
        batch = dict(add=([s], [d], np.array([7.5], np.float32)))
    else:
        batch = dict(add=([0, 3], [63, 7]), remove=([int(src[1])],
                                                     [int(dst[1])]))
    rep = st.apply(DeltaBatch.build(**batch))
    jrep = jst.apply(JBatch.build(**batch))
    assert rep.in_place is False and jrep.in_place is False
    _same_csr(st.graph, jst.graph)
    for f, data in before.items():
        assert open(os.path.join(sub, f), "rb").read() == data, f
