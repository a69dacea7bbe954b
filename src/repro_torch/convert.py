"""Carry state from the JAX package into the port.

This system's counterpart of carrying weights across: a device layout built
by ``repro.core.graph.PaddedGraph.build``, a ``jax.random`` key, SGNS
parameters, the LM's params and Adam state (of either), each handed over
as numpy arrays (``np.asarray`` of every field), become the port's
:class:`PaddedGraph`, key, params dicts and :class:`AdamState`. Nothing
here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import FIELDS, PaddedGraph
from repro_torch.device import resolve_device
from repro_torch.models.model import encoder_config
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
    """float32 tensors on ``dev`` of a dict of arrays, nested freely."""
    return {k: _tables(v, dev) if isinstance(v, dict) else
            torch.from_numpy(np.array(v, np.float32)).to(dev)
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
    dict of numpy arrays) -> the port's :class:`AdamState`. The moments
    may be SGNS tables or an LM's params tree (float32 moments of float32
    params)."""
    if not isinstance(state, dict):
        state = state._asdict()
    dev = resolve_device(device)
    count = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                         device=dev)
    return AdamState(count, _tables(state["mu"], dev),
                     _tables(state["nu"], dev))


def _tree(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)


def lm_params_from_numpy(params: dict, cfg, device=None) -> dict:
    """The JAX LM ``init_params`` pytree (``np.asarray`` of each leaf) ->
    the port's params (tensors of the same dtypes on ``device``). Checks
    the tree's top level (``encoder`` with an encoder-decoder config), the
    table shape and the superblock stacking of ``blocks`` against ``cfg``
    and of ``encoder`` against ``encoder_config(cfg)``."""
    stacks = {"blocks": cfg}
    if cfg.enc_layers:
        stacks["encoder"] = encoder_config(cfg)
    if set(params) != {"embed", *stacks}:
        raise ValueError(f"expected params with 'embed' and "
                         f"{sorted(stacks)}, got {sorted(params)}")
    tok = np.shape(params["embed"]["tok"])
    if tok != (cfg.vocab, cfg.d_model):
        raise ValueError(f"embedding table {tok} does not fit {cfg.name}: "
                         f"({cfg.vocab}, {cfg.d_model})")
    for top, c in stacks.items():
        want = {f"l{i}" for i in range(len(c.superblock()))}
        if set(params[top]) != want:
            raise ValueError(f"{top} {sorted(params[top])}, expected "
                             f"{sorted(want)}")
    out = _tree(params, resolve_device(device))
    for top, c in stacks.items():
        for name, leaf in _leaves(out[top]):
            if leaf.shape[0] != c.num_superblocks:
                raise ValueError(f"{top}/{name} stacks {leaf.shape[0]} "
                                 f"superblocks, expected "
                                 f"{c.num_superblocks}")
    return out


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v
