"""GraphStore — read-only port of ``repro.data.store``.

``open_graph`` is the one entry point from a graph source to a host CSR
graph::

    store = open_graph("wec:k=16,deg=100,seed=0")
    store.graph            # host CSRGraph
    store.version          # 0: this port applies no deltas yet

It accepts a spec string, a :class:`CSRGraph`, a
:class:`~repro_torch.data.ingest.Dataset` or a store (returned as is).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.data.ingest import Dataset, load_dataset


class GraphStore:
    """A handle over one resident host graph, with its sidecars."""

    def __init__(self, dataset: Dataset) -> None:
        self._graph = dataset.graph
        self.spec = dataset.spec
        self.labels = dataset.labels
        self.perm = None if dataset.perm is None \
            else np.asarray(dataset.perm, np.int64)
        self.version = 0

    @property
    def graph(self) -> CSRGraph:
        return self._graph


def open_graph(source) -> GraphStore:
    """Open a spec string, CSRGraph, Dataset or GraphStore as a store."""
    if isinstance(source, GraphStore):
        return source
    if isinstance(source, Dataset):
        return GraphStore(source)
    if isinstance(source, CSRGraph):
        return GraphStore(Dataset(graph=source, spec="<CSRGraph>"))
    if not isinstance(source, str):
        raise TypeError(
            f"open_graph wants a spec string, CSRGraph, Dataset, or "
            f"GraphStore; got {type(source).__name__}")
    return GraphStore(load_dataset(source))
