"""Carry state from the JAX package into the port.

This system's counterpart of carrying weights across: a device layout built
by ``repro.core.graph.PaddedGraph.build`` and a ``jax.random`` key, each
handed over as numpy arrays (``np.asarray`` of every field), become the
port's :class:`PaddedGraph` and key. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import FIELDS, PaddedGraph
from repro_torch.device import resolve_device


def padded_graph_from_numpy(fields: dict, n: int, cap: int, hot_cap: int,
                            device=None) -> PaddedGraph:
    """``fields`` maps every ``PaddedGraph`` field name to a numpy array."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise ValueError(f"layout is missing fields {missing}")
    pg = PaddedGraph.from_numpy(fields, n, resolve_device(device))
    if (pg.n, pg.cap, pg.hot_cap) != (n, cap, hot_cap) \
            or pg.adj.shape[0] != n:
        raise ValueError(
            f"arrays give n={pg.adj.shape[0]}, cap={pg.cap}, "
            f"hot_cap={pg.hot_cap}; expected n={n}, cap={cap}, "
            f"hot_cap={hot_cap}")
    return pg


def key_from_numpy(key) -> torch.Tensor:
    """A JAX ``uint32[2]`` key, as a numpy array, -> the port's key."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"expected a uint32[2] key, got {key.dtype}"
                         f"{list(key.shape)}")
    return torch.from_numpy(key.astype(np.int64))
