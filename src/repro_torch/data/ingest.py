"""Graph spec registry — port of the part of ``repro.data.ingest`` that the
walk path needs: the spec grammar, the synthetic families and
degree-descending relabelling::

    "er:k=10,deg=10,seed=0"        "wec:k=12,deg=100"
    "skew:s=3,k=10,deg=30"         "rmat:k=18,deg=16,a=0.45,b=0.22,c=0.22"
    "sbm:n=400,c=4,pin=0.06,pout=0.01"

``relabel=degree`` is understood by every family, ``seed=<int>`` by all of
them. Unknown options are rejected, not ignored. New families plug in via
:func:`register_family`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core import rmat
from repro_torch.core.graph import CSRGraph


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


for _name, _fn, _keys in [
        ("er", _build_er, ("k", "deg", "seed")),
        ("wec", _build_wec, ("k", "deg", "seed")),
        ("skew", _build_skew, ("s", "k", "deg", "seed")),
        ("rmat", _build_rmat, ("k", "deg", "a", "b", "c", "d", "seed")),
        ("sbm", _build_sbm, ("n", "c", "pin", "pout", "seed"))]:
    register_family(_name, _fn, _keys)

_COMMON_OPTS = frozenset(("relabel",))


def load_dataset(spec: str) -> Dataset:
    """Resolve a graph spec string to a :class:`Dataset`."""
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
    out = make(arg, opts)
    g, labels = out if isinstance(out, tuple) else (out, None)
    perm = None
    if relabel is not None:
        g, perm = relabel_by_degree(g)
        if labels is not None:
            labels = np.asarray(labels)[np.argsort(perm)]   # new -> old id
    return Dataset(graph=g, spec=spec, labels=labels, perm=perm)
