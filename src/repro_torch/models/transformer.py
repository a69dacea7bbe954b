"""Stack assembler — port of ``repro.models.transformer``.

A superblock is the repeating layer pattern from ``ModelConfig.superblock()``.
Parameters and caches are stacked [NSB, ...] per pattern position, with the
JAX package's key tree; a Python loop over superblocks takes the place of
``lax.scan``. Training (``stack_train``) unbinds the stacked params once
(one stack of grads in the backward) and, with ``cfg.remat``, wraps each
superblock in ``torch.utils.checkpoint`` (non-reentrant): its activations
are recomputed in the backward, as ``jax.checkpoint`` does, and no value
changes. Prefill and decode write the stacked caches in place through
per-superblock views: attention layers fill their KV caches in place,
and mamba layers copy their new state into the cache's views. Self-
attention and mamba layers with dense or MoE FFNs are ported;
cross-attention layers raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as jr
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import init_mlp, init_rms, mlp_apply, rms_norm

_LATER = {"cross_attn": "cross-attention layers: ROADMAP Queue 1 item 11e",
          "attn_cross": "encoder-decoder layers: ROADMAP Queue 1 item 11e"}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` if ``cfg`` has a layer kind or FFN the
    port does not run yet."""
    for spec in cfg.superblock():
        for part in (spec.kind, spec.ffn):
            if part in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: {_LATER[part]} (not ported yet)")


def _stack(trees: List[Dict]) -> Dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in
            trees[0].items()}


def _index(tree: Dict, j: int) -> Dict:
    """Superblock j's slice of a stacked tree (views)."""
    return {k: _index(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def _unbind(tree: Dict, n: int) -> List[Dict]:
    """The n superblocks' trees of a stacked tree (``unbind`` views: their
    grads are stacked once in the backward)."""
    out: List[Dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
        for j in range(n):
            out[j][k] = parts[j]
    return out


# ---------------- init ----------------

def init_layer(cfg: ModelConfig, spec: LayerSpec,
               key: torch.Tensor) -> Dict:
    check_ported(cfg)
    k1, k2, _ = jr.split(key, 3)
    p: Dict = {"pre_norm": init_rms(cfg, key.device)}
    if spec.kind == "attn":
        p["attn"] = attn.init_attn(cfg, k1)
    else:
        p["mamba"] = mb.init_mamba(cfg, k1)
    if spec.ffn != "none":
        p["post_norm"] = init_rms(cfg, key.device)
        p["ffn"] = (moe_lib.init_moe(cfg, k2) if spec.ffn == "moe"
                    else init_mlp(cfg, k2))
    return p


def init_blocks(cfg: ModelConfig, key: torch.Tensor) -> Dict:
    """Stacked per-pattern-position params: {"l0": stacked, "l1": ...}."""
    nsb = cfg.num_superblocks
    out = {}
    for i, spec in enumerate(cfg.superblock()):
        keys = jr.split(jr.fold_in(key, i), nsb)
        out[f"l{i}"] = _stack([init_layer(cfg, spec, keys[j])
                               for j in range(nsb)])
    return out


def _ffn(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor):
    if spec.ffn == "none":
        return x
    h = rms_norm(x, p["post_norm"])
    if spec.ffn == "moe":   # one routing group: B*S tokens route together
        return x + moe_lib.moe_apply(cfg, p["ffn"], h, 1)
    return x + mlp_apply(cfg, p["ffn"], h)


def _write(cache: Dict, new: Dict) -> None:
    """Copy a mamba layer's new state into its cache's views."""
    for k, v in new.items():
        cache[k].copy_(v)


# ---------------- one superblock ----------------

def superblock_train(cfg: ModelConfig, params_sb: Dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    for i, spec in enumerate(cfg.superblock()):
        p = params_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        if spec.kind == "attn":
            x = x + attn.attn_train(cfg, p["attn"], h, positions,
                                    causal=causal)
        else:
            x = x + mb.mamba_apply(cfg, p["mamba"], h)
        x = _ffn(cfg, spec, p, x)
    return x


def stack_train(cfg: ModelConfig, blocks: Dict, x: torch.Tensor,
                positions: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                causal: bool = True) -> torch.Tensor:
    """The training forward through every superblock; with ``cfg.remat``
    each superblock's activations are recomputed in the backward."""
    check_ported(cfg)
    if memory is not None:
        raise NotImplementedError(
            "cross-attention memory: ROADMAP Queue 1 item 11e (not ported "
            "yet)")
    for params_sb in _unbind(blocks, cfg.num_superblocks):
        if cfg.remat:
            x = checkpoint(superblock_train, cfg, params_sb, x, positions,
                           causal, use_reentrant=False)
        else:
            x = superblock_train(cfg, params_sb, x, positions, causal)
    return x


# ---------------- caches ----------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device=None) -> Dict:
    check_ported(cfg)
    if spec.kind == "attn":
        return attn.init_cache(cfg, batch, max_len, dtype, device)
    return mb.init_mamba_cache(cfg, batch, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None) -> Dict:
    nsb = cfg.num_superblocks
    out = {}
    for i, spec in enumerate(cfg.superblock()):
        one = init_layer_cache(cfg, spec, batch, max_len, dtype, device)
        out[f"l{i}"] = {k: v.expand(nsb, *v.shape).clone()
                        for k, v in one.items()}
    return out


# ---------------- decode ----------------

def superblock_decode(cfg: ModelConfig, params_sb: Dict, cache_sb: Dict,
                      x: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Dict]:
    for i, spec in enumerate(cfg.superblock()):
        p, c = params_sb[f"l{i}"], cache_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        if spec.kind == "attn":
            o, _ = attn.attn_decode(cfg, p["attn"], h, pos, c)
        else:
            o, new = mb.mamba_decode(cfg, p["mamba"], h, c)
            _write(c, new)
        x = _ffn(cfg, spec, p, x + o)
    return x, cache_sb


def stack_decode(cfg: ModelConfig, blocks: Dict, caches: Dict,
                 x: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Dict]:
    check_ported(cfg)
    for j in range(cfg.num_superblocks):
        x, _ = superblock_decode(cfg, _index(blocks, j), _index(caches, j),
                                 x, pos)
    return x, caches


# ---------------- prefill ----------------

def superblock_prefill(cfg: ModelConfig, params_sb: Dict, cache_sb: Dict,
                       x: torch.Tensor,
                       positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    for i, spec in enumerate(cfg.superblock()):
        p, c = params_sb[f"l{i}"], cache_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        if spec.kind == "attn":
            o, _ = attn.attn_prefill(cfg, p["attn"], h, positions, c)
        else:
            o, new = mb.mamba_prefill(cfg, p["mamba"], h)
            _write(c, new)
        x = _ffn(cfg, spec, p, x + o)
    return x, cache_sb


def stack_prefill(cfg: ModelConfig, blocks: Dict, caches: Dict,
                  x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    check_ported(cfg)
    for j in range(cfg.num_superblocks):
        x, _ = superblock_prefill(cfg, _index(blocks, j), _index(caches, j),
                                  x, positions)
    return x, caches
