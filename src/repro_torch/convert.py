"""Carry state from the JAX package into the port.

This system's counterpart of carrying weights across: a device layout built
by ``repro.core.graph.PaddedGraph.build``, a ``jax.random`` key, SGNS
parameters and Adam state, each handed over as numpy arrays (``np.asarray``
of every field), become the port's :class:`PaddedGraph`, key, params dict
and :class:`AdamState`. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import FIELDS, PaddedGraph
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import AdamState


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


def _tables(tree: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in tree.items()}


def sgns_params_from_numpy(params: dict, device=None) -> dict:
    """A JAX SGNS params dict (``emb_in``, ``emb_out``) as numpy arrays ->
    the port's params (float32 tensors on ``device``)."""
    missing = {"emb_in", "emb_out"} - set(params)
    if missing:
        raise ValueError(f"params are missing {sorted(missing)}")
    return _tables(params, resolve_device(device))


def adam_state_from_numpy(state, device=None) -> AdamState:
    """A JAX ``AdamState`` (``count``, ``mu``, ``nu``; a NamedTuple or a
    dict of numpy arrays) -> the port's :class:`AdamState`."""
    if not isinstance(state, dict):
        state = state._asdict()
    dev = resolve_device(device)
    count = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                         device=dev)
    return AdamState(count, _tables(state["mu"], dev),
                     _tables(state["nu"], dev))
