"""Streaming graph ingestion and the dataset registry — port of
``repro.data.ingest``.

* :func:`csr_from_chunks` — the chunked, memory-bounded two-pass edge list
  -> CSR builder: pass 1 counts degrees, pass 2 counting-sorts each chunk
  into the preallocated ``indptr``/``col``/``wgt`` arrays, a last pass
  sorts and dedups rows in place, block by block. Peak transient memory is
  O(n + chunk) beyond the CSR itself.
* :func:`save_csr` / :func:`load_csr` — the binary CSR cache
  (``{indptr,col,wgt}.npy`` + ``meta.json``, the JAX package's format, so
  a cache either package writes loads in the other); loads are
  ``np.memmap``-backed.
* :func:`load_dataset` — one spec-string registry over the synthetic
  families and on-disk sources::

      "er:k=10,deg=10,seed=0"        "wec:k=12,deg=100"
      "skew:s=3,k=10,deg=30"         "rmat:k=18,deg=16,a=0.45,b=0.22,c=0.22"
      "sbm:n=400,c=4,pin=0.06,pout=0.01"
      "edgelist:/path/graph.txt"     "edgelist:/path/graph.txt,n=4096"
      "csr:/path/cache_dir"

  ``relabel=degree`` is understood by every family, ``seed=<int>`` by the
  synthetic ones. ``edgelist:`` also takes ``n=``, ``directed=1``,
  ``dedup=0`` and ``chunk=<edges>``; with ``cache_dir=`` it builds once and
  memmaps thereafter. Unknown options are rejected, not ignored. New
  families plug in via :func:`register_family`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core import rmat
from repro_torch.core.graph import CSRGraph

DEFAULT_CHUNK_EDGES = 1 << 18
CSR_FORMAT_VERSION = 1

_COMMENT_PREFIXES = ("#", "%", "//")

Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (src i64, dst i64, w f32)


def iter_edgelist_chunks(path: str,
                         chunk_edges: int = DEFAULT_CHUNK_EDGES
                         ) -> Iterator[Chunk]:
    """Stream ``(src, dst, wgt)`` chunks from a whitespace/comma separated
    text edge list. Lines starting with ``#``, ``%`` or ``//`` are comments;
    a third column, when present, is the edge weight (default 1.0)."""
    src, dst, wgt = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(_COMMENT_PREFIXES):
                continue
            parts = line.replace(",", " ").split()
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            wgt.append(float(parts[2]) if len(parts) > 2 else 1.0)
            if len(src) >= chunk_edges:
                yield (np.asarray(src, np.int64), np.asarray(dst, np.int64),
                       np.asarray(wgt, np.float32))
                src, dst, wgt = [], [], []
    if src:
        yield (np.asarray(src, np.int64), np.asarray(dst, np.int64),
               np.asarray(wgt, np.float32))


def write_edgelist(path: str, src: np.ndarray, dst: np.ndarray,
                   wgt: Optional[np.ndarray] = None) -> None:
    """Inverse of :func:`iter_edgelist_chunks` (tests, dataset prep)."""
    with open(path, "w") as f:
        f.write("# src dst [wgt]\n")
        if wgt is None:
            for s, d in zip(src, dst):
                f.write(f"{int(s)} {int(d)}\n")
        else:
            for s, d, w in zip(src, dst, wgt):
                f.write(f"{int(s)} {int(d)} {float(w):.8g}\n")


def csr_from_chunks(chunks: Callable[[], Iterable[Chunk]],
                    n: Optional[int] = None,
                    undirected: bool = True,
                    dedup: bool = True,
                    block_edges: int = DEFAULT_CHUNK_EDGES) -> CSRGraph:
    """Memory-bounded CSR build from a restartable chunk stream.

    ``chunks`` is a zero-arg callable returning a fresh iterator of
    ``(src, dst, wgt)`` arrays on each call (the stream is read twice).
    Self loops are dropped, ``undirected`` adds reverse edges, ``dedup``
    keeps the first-arriving weight per (u, v) in chunk-stream order. The
    result equals :meth:`CSRGraph.from_edges` except where one undirected
    edge appears more than once with conflicting weights (``from_edges``
    orders all forward edges before all reverse ones, this builder per
    chunk).

    Peak transient allocation is O(n + chunk): pass 1 keeps only the degree
    counts; pass 2 counting-sorts each chunk into the preallocated output
    arrays; pass 3 sorts and dedups row blocks of at most ``block_edges``
    edges and compacts in place (the write cursor never passes the read
    cursor).
    """
    # pass 1: degree counts (and n discovery)
    counts = np.zeros(1024 if n is None else n, dtype=np.int64)
    n_seen = 0
    for src, dst, _ in chunks():
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if not src.size:
            continue
        hi = int(max(src.max(), dst.max())) + 1
        n_seen = max(n_seen, hi)
        if n is None and hi > counts.shape[0]:
            grown = np.zeros(max(hi, 2 * counts.shape[0]), np.int64)
            grown[:counts.shape[0]] = counts
            counts = grown
        elif n is not None and hi > n:
            raise ValueError(f"vertex id {hi - 1} >= n={n}")
        cb = np.bincount(src)
        counts[:cb.shape[0]] += cb
        if undirected:
            cb = np.bincount(dst)
            counts[:cb.shape[0]] += cb
    if n is None:
        n = n_seen
        counts = counts[:n]
    m_placed = int(counts.sum())

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    col = np.empty(m_placed, dtype=np.int32)
    wgt = np.empty(m_placed, dtype=np.float32)
    cursor = indptr[:-1].copy()

    # pass 2: counting-sort placement into the preallocated arrays
    for src, dst, w in chunks():
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        w = (np.ones(src.shape[0], np.float32) if w is None
             else np.asarray(w, np.float32))
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
        if undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            w = np.concatenate([w, w])
        if not src.size:
            continue
        order = np.argsort(src, kind="stable")
        ss, dd, ww = src[order], dst[order], w[order]
        run_start = np.searchsorted(ss, ss, side="left")
        pos = cursor[ss] + (np.arange(ss.shape[0], dtype=np.int64) - run_start)
        col[pos] = dd
        wgt[pos] = ww
        cb = np.bincount(ss, minlength=n)
        cursor += cb[:n]

    # pass 3: in-place streaming row sort + dedup (block compaction)
    write = 0
    new_counts = np.zeros(n, dtype=np.int64)
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + block_edges,
                                 side="right"))
        r1 = min(max(r1, r0 + 1), n)  # always >= 1 row, even a huge one
        lo, hi = int(indptr[r0]), int(indptr[r1])
        lens = indptr[r0 + 1:r1 + 1] - indptr[r0:r1]
        rid = np.repeat(np.arange(r1 - r0, dtype=np.int64), lens)
        order = np.lexsort((col[lo:hi], rid))
        c, w_, rs = col[lo:hi][order], wgt[lo:hi][order], rid[order]
        if dedup and c.size:
            first = np.ones(c.shape[0], dtype=bool)
            first[1:] = (c[1:] != c[:-1]) | (rs[1:] != rs[:-1])
            c, w_, rs = c[first], w_[first], rs[first]
        col[write:write + c.shape[0]] = c
        wgt[write:write + c.shape[0]] = w_
        new_counts[r0:r1] = np.bincount(rs, minlength=r1 - r0)
        write += c.shape[0]
        r0 = r1

    np.cumsum(new_counts, out=indptr[1:])
    return CSRGraph(n=n, row_ptr=indptr, col=col[:write], wgt=wgt[:write])


def edgelist_to_csr(path: str, n: Optional[int] = None,
                    undirected: bool = True, dedup: bool = True,
                    chunk_edges: int = DEFAULT_CHUNK_EDGES) -> CSRGraph:
    """Chunked two-pass build of a text edge list (see
    :func:`csr_from_chunks`)."""
    return csr_from_chunks(
        lambda: iter_edgelist_chunks(path, chunk_edges=chunk_edges),
        n=n, undirected=undirected, dedup=dedup, block_edges=chunk_edges)


def save_csr(g: CSRGraph, dirpath: str, graph_version: int = 0) -> str:
    """Write ``g`` as ``{indptr,col,wgt}.npy`` + ``meta.json`` under
    ``dirpath``. ``graph_version`` is the saved graph's delta counter (0
    for a fresh build), so a reloaded ``GraphStore`` resumes at it."""
    os.makedirs(dirpath, exist_ok=True)
    np.save(os.path.join(dirpath, "indptr.npy"), g.row_ptr)
    np.save(os.path.join(dirpath, "col.npy"), g.col)
    np.save(os.path.join(dirpath, "wgt.npy"), g.wgt)
    meta = {"version": CSR_FORMAT_VERSION, "n": int(g.n), "m": int(g.m),
            "graph_version": int(graph_version)}
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)
    return dirpath


def csr_meta(dirpath: str) -> dict:
    """The ``meta.json`` of a :func:`save_csr` directory (``graph_version``
    defaults to 0 for caches written before deltas existed)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    meta.setdefault("graph_version", 0)
    return meta


def load_csr(dirpath: str, mmap: bool = True) -> CSRGraph:
    """Load a :func:`save_csr` directory; ``mmap=True`` (default) maps the
    arrays read-only via ``np.memmap`` instead of reading them into RSS."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != CSR_FORMAT_VERSION:
        raise ValueError(
            f"CSR cache {dirpath} has version {meta.get('version')}, "
            f"want {CSR_FORMAT_VERSION} — rebuild the cache")
    mode = "r" if mmap else None
    return CSRGraph(
        n=int(meta["n"]),
        row_ptr=np.load(os.path.join(dirpath, "indptr.npy"), mmap_mode=mode),
        col=np.load(os.path.join(dirpath, "col.npy"), mmap_mode=mode),
        wgt=np.load(os.path.join(dirpath, "wgt.npy"), mmap_mode=mode))


def relabel_by_degree(g: CSRGraph) -> Tuple[CSRGraph, np.ndarray]:
    """Relabel vertices in descending-degree order (ties: ascending old id).

    Returns ``(relabeled, perm)`` with ``perm[old_id] == new_id``; the
    FN-Cache hot set becomes the contiguous prefix ``[0, K)``.
    """
    deg = g.deg.astype(np.int64)
    order = np.lexsort((np.arange(g.n), -deg))     # old ids in new-id order
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    lens = deg[order]
    indptr = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    # segment gather: edges of old row order[i] land in new row i
    idx = (np.repeat(g.row_ptr[order], lens)
           + (np.arange(g.m, dtype=np.int64)
              - np.repeat(indptr[:-1], lens)))
    col = perm[g.col[idx].astype(np.int64)].astype(np.int32)
    wgt = np.asarray(g.wgt)[idx]
    rid = np.repeat(np.arange(g.n, dtype=np.int64), lens)
    o2 = np.lexsort((col, rid))                    # re-sort rows ascending
    return CSRGraph(n=g.n, row_ptr=indptr, col=col[o2], wgt=wgt[o2]), perm


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A loaded graph plus sidecars: ``labels`` (``sbm:`` family, indexed by
    current vertex ids) and ``perm`` (old -> new ids under relabel)."""
    graph: CSRGraph
    spec: str
    labels: Optional[np.ndarray] = None
    perm: Optional[np.ndarray] = None


_REGISTRY: dict = {}


def register_family(name: str, make: Callable,
                    keys: Tuple[str, ...] = ()) -> None:
    """Register ``make(arg, opts) -> CSRGraph | (CSRGraph, labels)`` for
    ``"{name}:..."`` specs; ``keys`` lists the options it understands."""
    _REGISTRY[name] = (make, frozenset(keys))


def families() -> tuple:
    return tuple(sorted(_REGISTRY))


def parse_spec(spec: str) -> Tuple[str, Optional[str], dict]:
    """``"family:pos,k=v,..."`` -> (family, pos_or_None, {k: v})."""
    family, _, rest = spec.partition(":")
    family = family.strip()
    if not family:
        raise ValueError(f"empty family in graph spec {spec!r}")
    arg, opts = None, {}
    for tok in rest.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            k, v = tok.split("=", 1)
            opts[k.strip()] = v.strip()
        elif arg is None:
            arg = tok
        else:
            raise ValueError(
                f"graph spec {spec!r} has two positional tokens "
                f"({arg!r}, {tok!r})")
    return family, arg, opts


def _opt(opts: dict, key: str, cast, default=None, required: bool = False):
    if key not in opts:
        if required:
            raise ValueError(f"graph spec option {key!r} is required")
        return default
    return cast(opts[key])


def _flag(opts: dict, key: str, default: bool = False) -> bool:
    v = opts.get(key)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "off")


def _build_er(arg, opts):
    return rmat.er(_opt(opts, "k", int, required=True),
                   avg_degree=_opt(opts, "deg", float, 10.0),
                   seed=_opt(opts, "seed", int, 0))


def _build_wec(arg, opts):
    return rmat.wec(_opt(opts, "k", int, required=True),
                    avg_degree=_opt(opts, "deg", float, 100.0),
                    seed=_opt(opts, "seed", int, 0))


def _build_skew(arg, opts):
    return rmat.skew(_opt(opts, "s", float, required=True),
                     k=_opt(opts, "k", int, 22),
                     avg_degree=_opt(opts, "deg", float, 100.0),
                     seed=_opt(opts, "seed", int, 0))


def _build_rmat(arg, opts):
    return rmat.rmat_graph(_opt(opts, "k", int, required=True),
                           _opt(opts, "deg", float, required=True),
                           _opt(opts, "a", float, 0.25),
                           _opt(opts, "b", float, 0.25),
                           _opt(opts, "c", float, 0.25),
                           _opt(opts, "d", float, 0.25),
                           seed=_opt(opts, "seed", int, 0))


def _build_sbm(arg, opts):
    return rmat.sbm_labeled(_opt(opts, "n", int, required=True),
                            _opt(opts, "c", int, required=True),
                            _opt(opts, "pin", float, required=True),
                            _opt(opts, "pout", float, required=True),
                            seed=_opt(opts, "seed", int, 0))


def _build_edgelist(arg, opts):
    if arg is None:
        raise ValueError("edgelist spec needs a path: 'edgelist:/path.txt'")
    return edgelist_to_csr(
        arg, n=_opt(opts, "n", int),
        undirected=not _flag(opts, "directed"),
        dedup=_flag(opts, "dedup", True),
        chunk_edges=_opt(opts, "chunk", int, DEFAULT_CHUNK_EDGES))


def _build_csr_dir(arg, opts):
    if arg is None:
        raise ValueError("csr spec needs a directory: 'csr:/path/dir'")
    return load_csr(arg, mmap=_flag(opts, "mmap", True))


for _name, _fn, _keys in [
        ("er", _build_er, ("k", "deg", "seed")),
        ("wec", _build_wec, ("k", "deg", "seed")),
        ("skew", _build_skew, ("s", "k", "deg", "seed")),
        ("rmat", _build_rmat, ("k", "deg", "a", "b", "c", "d", "seed")),
        ("sbm", _build_sbm, ("n", "c", "pin", "pout", "seed")),
        ("edgelist", _build_edgelist, ("n", "directed", "dedup", "chunk")),
        ("csr", _build_csr_dir, ("mmap",))]:
    register_family(_name, _fn, _keys)

_COMMON_OPTS = frozenset(("relabel",))


def _edgelist_cache_key(path: str, opts: dict, graph_version: int = 0) -> str:
    # relabel is part of the key: the cached artifact is the final graph.
    # graph_version keeps a patched graph from aliasing the entry of its
    # pre-patch ancestor, whose mtime and size it may share exactly
    st = os.stat(path)
    tag = (f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|"
           f"v{CSR_FORMAT_VERSION}|gv{int(graph_version)}|"
           f"{sorted(opts.items())}")
    return hashlib.sha1(tag.encode()).hexdigest()[:12]


def _cached_edgelist(make, arg, opts, relabel, spec: str,
                     cache_dir: str) -> Dataset:
    """Build the edge list (and its relabel) once into ``cache_dir`` and
    memmap it from there, ``perm.npy`` beside the graph."""
    if arg is None:
        raise ValueError("edgelist spec needs a path: 'edgelist:/path.txt'")
    key = _edgelist_cache_key(arg, opts)
    sub = os.path.join(cache_dir, f"{os.path.basename(arg)}-{key}")
    perm_path = os.path.join(sub, "perm.npy")
    if not os.path.exists(os.path.join(sub, "meta.json")):
        g = make(arg, opts)
        perm = None
        if relabel is not None:
            g, perm = relabel_by_degree(g)
        # build into a temp dir and rename it into place, so a concurrent
        # loader never memmaps a partly written cache
        tmp = f"{sub}.tmp{os.getpid()}"
        save_csr(g, tmp)
        if perm is not None:
            np.save(os.path.join(tmp, "perm.npy"), perm)
        try:
            os.rename(tmp, sub)
        except OSError:                     # another process won
            shutil.rmtree(tmp, ignore_errors=True)
    perm = np.load(perm_path, mmap_mode="r") \
        if os.path.exists(perm_path) else None
    return Dataset(graph=load_csr(sub), spec=spec, labels=None, perm=perm)


def load_dataset(spec: str, cache_dir: Optional[str] = None) -> Dataset:
    """Resolve a graph spec string to a :class:`Dataset`.

    ``cache_dir`` (edgelist family only): the chunked build, and any
    ``relabel=degree`` pass, runs once and is written as a binary CSR cache
    keyed on (path, mtime, size, options, graph version); later loads are
    ``np.memmap``-backed from it.
    """
    family, arg, opts = parse_spec(spec)
    if family not in _REGISTRY:
        raise ValueError(
            f"unknown graph family {family!r} (have {families()}); spec was "
            f"{spec!r}")
    make, known_keys = _REGISTRY[family]
    unknown = set(opts) - known_keys - _COMMON_OPTS
    if unknown:
        raise ValueError(
            f"unknown option(s) {sorted(unknown)} for graph family "
            f"{family!r} (known: {sorted(known_keys | _COMMON_OPTS)}); "
            f"spec was {spec!r}")
    relabel = opts.get("relabel")
    if relabel not in (None, "degree", "1", "true"):
        raise ValueError(f"unknown relabel option {relabel!r} (want 'degree')")
    if family == "edgelist" and cache_dir is not None:
        return _cached_edgelist(make, arg, opts, relabel, spec, cache_dir)
    out = make(arg, opts)
    g, labels = out if isinstance(out, tuple) else (out, None)
    perm = None
    if relabel is not None:
        g, perm = relabel_by_degree(g)
        if labels is not None:
            labels = np.asarray(labels)[np.argsort(perm)]   # new -> old id
    return Dataset(graph=g, spec=spec, labels=labels, perm=perm)
