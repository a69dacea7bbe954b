"""GraphStore — the versioned graph handle, port of ``repro.data.store``.

``open_graph`` is the one entry point from a graph source to a host CSR
graph::

    store = open_graph("wec:k=16,deg=100,seed=0")
    store.graph            # host CSRGraph (the current version)
    store.version          # delta counter, 0 at open
    store.apply(deltas)    # patch in a DeltaBatch -> PatchReport, version += 1
    store.save(dirpath)    # a "csr:" directory that reopens at this version

It accepts a spec string, a :class:`CSRGraph`, a
:class:`~repro_torch.data.ingest.Dataset` or a store (returned as is), so
``WalkEngine.build`` and ``serve.EmbeddingService`` hold the store their
``update``/``refresh`` paths patch.

Under ``relabel=degree`` deltas are expressed in the original vertex ids
and mapped through the permutation frozen at open time, which is never
recomputed after deltas (reopen to re-rank).
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Union

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.data.deltas import DeltaBatch, PatchReport, apply_delta_csr
from repro_torch.data.ingest import (Dataset, csr_meta, load_dataset,
                                     parse_spec, save_csr)

DEFAULT_PATCH_SHARDS = 64


class GraphStore:
    """A mutable, versioned handle over one resident host graph.

    ``version`` counts applied :class:`DeltaBatch` es (each batch one atomic
    bump). ``num_shards`` is the patch granularity of
    :func:`~repro_torch.data.deltas.apply_delta_csr`, independent of any
    device layout.
    """

    def __init__(self, dataset: Dataset, *,
                 num_shards: int = DEFAULT_PATCH_SHARDS,
                 version: int = 0) -> None:
        self._graph = dataset.graph
        self.spec = dataset.spec
        self.labels = dataset.labels
        self.perm = None if dataset.perm is None \
            else np.asarray(dataset.perm, np.int64)
        self.num_shards = max(1, int(num_shards))
        self.version = int(version)
        self.last_report: Optional[PatchReport] = None

    @property
    def graph(self) -> CSRGraph:
        """The current-version host CSR graph."""
        return self._graph

    def apply(self, deltas: Union[DeltaBatch, Iterable[DeltaBatch]]
              ) -> PatchReport:
        """Apply one batch (or a sequence, each a version bump) and return
        the (merged) :class:`~repro_torch.data.deltas.PatchReport`.

        A batch whose ``base_version`` is set must match the store's
        current version. Delta ids are original-space under relabelling.
        """
        batches = [deltas] if isinstance(deltas, DeltaBatch) else list(deltas)
        if not batches:
            raise ValueError("apply() needs at least one DeltaBatch")
        report = None
        for batch in batches:
            if not isinstance(batch, DeltaBatch):
                raise TypeError(
                    f"expected DeltaBatch, got {type(batch).__name__} — "
                    f"build one with DeltaBatch.build(add=..., remove=...)")
            if batch.base_version is not None \
                    and batch.base_version != self.version:
                raise ValueError(
                    f"stale delta batch: built against version "
                    f"{batch.base_version}, store is at {self.version}")
            mapped = batch if self.perm is None else batch.remap(self.perm)
            self._graph, rep = apply_delta_csr(
                self._graph, mapped, num_shards=self.num_shards)
            self.version += 1
            report = rep if report is None else report.merge(rep)
        self.last_report = report
        return report

    def save(self, dirpath: str) -> str:
        """Persist the current version as a ``csr:`` directory (graph,
        version, and the perm/labels sidecars);
        ``open_graph(f"csr:{dirpath}")`` restores the store at the same
        version."""
        save_csr(self._graph, dirpath, graph_version=self.version)
        if self.perm is not None:
            np.save(os.path.join(dirpath, "perm.npy"), self.perm)
        if self.labels is not None:
            np.save(os.path.join(dirpath, "labels.npy"),
                    np.asarray(self.labels))
        return dirpath


def open_graph(source, cache_dir: Optional[str] = None, *,
               num_shards: int = DEFAULT_PATCH_SHARDS) -> GraphStore:
    """Open a spec string, CSRGraph, Dataset or GraphStore as a store.

    ``cache_dir`` is forwarded to the edgelist builder (build once, memmap
    thereafter). A ``csr:`` directory written by :meth:`GraphStore.save`
    reopens at its saved version with its perm and labels."""
    if isinstance(source, GraphStore):
        return source
    if isinstance(source, Dataset):
        return GraphStore(source, num_shards=num_shards)
    if isinstance(source, CSRGraph):
        return GraphStore(Dataset(graph=source, spec="<CSRGraph>"),
                          num_shards=num_shards)
    if not isinstance(source, str):
        raise TypeError(
            f"open_graph wants a spec string, CSRGraph, Dataset, or "
            f"GraphStore; got {type(source).__name__}")
    ds = load_dataset(source, cache_dir=cache_dir)
    version = 0
    family, arg, _ = parse_spec(source)
    if family == "csr" and arg is not None:
        version = int(csr_meta(arg).get("graph_version", 0))
        ds = Dataset(graph=ds.graph, spec=ds.spec,
                     labels=_sidecar(arg, "labels", ds.labels),
                     perm=_sidecar(arg, "perm", ds.perm))
    return GraphStore(ds, num_shards=num_shards, version=version)


def _sidecar(dirpath: str, name: str, have):
    """``have``, else ``<dirpath>/<name>.npy`` where it exists, else None."""
    path = os.path.join(dirpath, f"{name}.npy")
    if have is not None or not os.path.exists(path):
        return have
    return np.load(path)
