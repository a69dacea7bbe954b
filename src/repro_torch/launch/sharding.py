"""Sharding rules: ModelConfig + mesh shape -> partition specs — port of
``repro.launch.sharding``, for the dry-run's per-device byte counts.

Scheme (MaxText-style 2D/3D), as the JAX package's:
  * ``model`` axis = tensor parallelism (attention heads / FFN hidden / vocab)
  * ``data``  axis = batch parallelism + FSDP weight sharding (each weight's
    non-TP dim is sharded over ``data``; gathered at use — ZeRO-3)
  * ``pod``   axis (multi-pod) = pure data parallelism.

Every rule is divisibility-checked: a dim is sharded over an axis only when
evenly divisible (GQA KV heads (4/8) and 24-head configs replicate over
``model``; their FSDP dim still shards). Decode KV caches shard the
*sequence* dim over ``model``.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
names, or ``None`` (replicated) — the tuple of JAX's ``PartitionSpec``.
The rules read only ``mesh.shape`` (``launch.mesh.MeshShape``). JAX's
``to_named`` (specs -> ``NamedSharding``) is not carried: the port has no
``NamedSharding``; :func:`per_device_bytes` reads the specs instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.models.config import ModelConfig

FSDP_AXIS = "data"
TP_AXIS = "model"
Spec = Tuple[Any, ...]


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _entry(axes: Tuple[str, ...]):
    """A spec entry over ``axes``: one axis by its name, as
    ``PartitionSpec`` normalises a 1-tuple."""
    return axes[0] if len(axes) == 1 else axes


def axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(math.prod(mesh.shape[n] for n in name))
    return int(mesh.shape.get(name, 1))


def _div(dim: int, mesh, axis) -> Any:
    """axis if it evenly divides dim else None (replicate)."""
    return axis if dim % max(axis_size(mesh, axis), 1) == 0 else None


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               serve_mode: bool = False) -> Spec:
    """Sharding rule for one parameter leaf, dispatched on its key path.

    Stacked block params carry a leading [NSB] axis — rules index from the
    right so they apply to both stacked and unstacked layouts.

    ``serve_mode``: inference layout — TP-only, replicated over ``data`` (no
    optimizer state, bf16 params), expert stacks expert-parallel over
    ``data`` where the expert count divides.
    """
    name = path[-1]
    fs, tp = (None, TP_AXIS) if serve_mode else (FSDP_AXIS, TP_AXIS)

    def spec(*dims_from_right):
        """Build a full-rank spec given specs for the trailing dims."""
        return (None,) * (len(shape) - len(dims_from_right)) + dims_from_right

    if name in ("tok", "unembed"):                       # [V, D]
        return spec(_div(shape[-2], mesh, tp), _div(shape[-1], mesh, fs))
    if name == "wq":                                     # [.., D, H, dh]
        return spec(_div(shape[-3], mesh, fs), _div(shape[-2], mesh, tp),
                    None)
    if name in ("wk", "wv"):                             # [.., D, KV, dh]
        return spec(_div(shape[-3], mesh, fs), _div(shape[-2], mesh, tp),
                    None)
    if name == "wo":                                     # [.., H, dh, D]
        return spec(_div(shape[-3], mesh, tp), None, _div(shape[-1], mesh,
                                                          fs))
    if name in ("gate", "up", "down"):
        # dense [.., D, F] / [.., F, D]  or  moe stacks [.., E, D, F]
        d1 = _div(shape[-2], mesh, tp if name == "down" else fs)
        d2 = _div(shape[-1], mesh, fs if name == "down" else tp)
        if serve_mode and len(shape) >= 3 and shape[-3] > 1:
            # serve-mode expert stacks: expert-parallel over `data` when E
            # divides, else FSDP on the non-TP dim
            e_ax = _div(shape[-3], mesh, FSDP_AXIS)
            if e_ax is None:
                d1 = _div(shape[-2], mesh,
                          tp if name == "down" else FSDP_AXIS)
                d2 = _div(shape[-1], mesh,
                          FSDP_AXIS if name == "down" else tp)
            return (None,) * (len(shape) - 3) + (e_ax, d1, d2)
        return spec(d1, d2)
    if name == "router":                                 # [.., D, E]
        return spec(_div(shape[-2], mesh, fs), None)
    if name == "in_proj":                                # [.., D, 2di+2ds+nh]
        return spec(_div(shape[-2], mesh, fs), _div(shape[-1], mesh, tp))
    if name == "out_proj":                               # [.., di, D]
        return spec(_div(shape[-2], mesh, tp), _div(shape[-1], mesh, fs))
    if name == "conv_w":                                 # [.., K, C]
        return spec(None, _div(shape[-1], mesh, tp))
    # norms, biases, per-head scalars: replicate
    return (None,) * len(shape)


def leaves_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(key path, leaf) of every leaf of nested dicts, in insertion order
    (a spec, a tuple, is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (str(k),))
    else:
        yield path, tree


def _map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params_shape: Any, mesh, cfg: ModelConfig,
                serve_mode: bool = False) -> Any:
    """Tree of specs matching a params (shape) tree."""
    return _map_with_path(lambda p, leaf: param_spec(
        p, tuple(leaf.shape), mesh, serve_mode), params_shape)


def batch_specs(batch_shape: Dict, mesh) -> Dict:
    """Leading-axis batch sharding over (pod, data); scalars replicated."""
    ba = batch_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        if v.ndim == 0 or v.shape[0] % max(axis_size(mesh, ba), 1) != 0:
            out[k] = ()
        else:
            out[k] = (_entry(ba),)
    return out


def cache_specs(caches_shape: Any, mesh, cfg: ModelConfig) -> Any:
    """KV caches: [NSB, B, S, KV, dh] -> batch over (pod,data) if divisible,
    S over model. Mamba states: heads over model. Cross memory: tokens over
    model."""
    ba = batch_axes(mesh)
    nb = axis_size(mesh, ba)

    def leaf_spec(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        b_ax = _entry(ba) if shape[1] % nb == 0 else None  # dim 1 = batch
        if name in ("k", "v", "mk", "mv"):         # [NSB, B, S, KV, dh]
            return (None, b_ax, _div(shape[2], mesh, TP_AXIS), None, None)
        if name == "h":                            # [NSB, B, nh, hd, ds]
            return (None, b_ax, _div(shape[2], mesh, TP_AXIS), None, None)
        if name in ("cx", "cb", "cc"):             # [NSB, B, K-1, C]
            return (None, b_ax, None, _div(shape[3], mesh, TP_AXIS))
        return (None,) * len(shape)

    return _map_with_path(leaf_spec, caches_shape)


def logits_spec(cfg: ModelConfig, mesh, batch: int) -> Spec:
    ba = batch_axes(mesh)
    b_ax = _entry(ba) if batch % max(axis_size(mesh, ba), 1) == 0 \
        else None
    v_ax = TP_AXIS if cfg.vocab % axis_size(mesh, TP_AXIS) == 0 else None
    return (b_ax, v_ax)


def shard_factor(spec: Spec, mesh) -> int:
    """How many pieces a leaf of ``spec`` is cut into: the product of the
    sizes of the axes it names."""
    return int(math.prod(1 if s is None else axis_size(mesh, s)
                         for s in spec))


def leaf_bytes(leaf: torch.Tensor) -> int:
    return leaf.numel() * leaf.element_size()


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, possibly on ``meta``)
    sharded by ``specs`` (a matching tree of specs, or one spec for every
    leaf): each leaf's bytes over its :func:`shard_factor` (the rules
    shard only evenly divisible dims)."""
    spec_of = dict(leaves_with_path(specs)) if isinstance(specs, dict) \
        else None
    total = 0
    for path, leaf in leaves_with_path(tree):
        spec = specs if spec_of is None else spec_of[path]
        total += leaf_bytes(leaf) // shard_factor(spec, mesh)
    return total
