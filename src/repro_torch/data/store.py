"""GraphStore — the versioned graph handle, port of ``repro.data.store``.

``open_graph`` is the one entry point from a graph source to a host CSR
graph::

    store = open_graph("wec:k=16,deg=100,seed=0")
    store.graph            # host CSRGraph (the current version)
    store.version          # delta counter, 0 at open
    store.apply(deltas)    # patch in a DeltaBatch -> PatchReport, version += 1

It accepts a spec string, a :class:`CSRGraph`, a
:class:`~repro_torch.data.ingest.Dataset` or a store (returned as is), so
``WalkEngine.build`` and ``serve.EmbeddingService`` hold the store their
``update``/``refresh`` paths patch.

Under ``relabel=degree`` deltas are expressed in the original vertex ids
and mapped through the permutation frozen at open time, which is never
recomputed after deltas (reopen to re-rank).
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.data.deltas import DeltaBatch, PatchReport, apply_delta_csr
from repro_torch.data.ingest import Dataset, load_dataset

DEFAULT_PATCH_SHARDS = 64


class GraphStore:
    """A mutable, versioned handle over one resident host graph.

    ``version`` counts applied :class:`DeltaBatch` es (each batch one atomic
    bump). ``num_shards`` is the patch granularity of
    :func:`~repro_torch.data.deltas.apply_delta_csr`, independent of any
    device layout.
    """

    def __init__(self, dataset: Dataset, *,
                 num_shards: int = DEFAULT_PATCH_SHARDS) -> None:
        self._graph = dataset.graph
        self.spec = dataset.spec
        self.labels = dataset.labels
        self.perm = None if dataset.perm is None \
            else np.asarray(dataset.perm, np.int64)
        self.num_shards = max(1, int(num_shards))
        self.version = 0
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
        raise NotImplementedError(
            "GraphStore.save needs save_csr, which is not ported yet: it is "
            "ROADMAP.md Queue 1 item 6 (Full ingest and graph handle)")


def open_graph(source, *,
               num_shards: int = DEFAULT_PATCH_SHARDS) -> GraphStore:
    """Open a spec string, CSRGraph, Dataset or GraphStore as a store."""
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
    return GraphStore(load_dataset(source), num_shards=num_shards)
