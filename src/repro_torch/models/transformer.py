"""Stack assembler — port of ``repro.models.transformer``.

A superblock is the repeating layer pattern from ``ModelConfig.superblock()``.
Parameters and caches are stacked [NSB, ...] per pattern position, with the
JAX package's key tree; a Python loop over superblocks takes the place of
``lax.scan``. Training (``stack_train``) unbinds the stacked params once
(one stack of grads in the backward) and, with ``cfg.remat``, wraps each
superblock in ``torch.utils.checkpoint`` (non-reentrant): its activations
are recomputed in the backward, as ``jax.checkpoint`` does, and no value
changes. Prefill and decode write the stacked caches in place through
per-superblock views. Only self-attention layers with dense FFNs are
ported so far; mamba, MoE and cross-attention layers raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as jr
from repro_torch.models import attention as attn
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import init_mlp, init_rms, mlp_apply, rms_norm

_LATER = {"mamba": "mamba layers: ROADMAP Queue 1 item 11d",
          "cross_attn": "cross-attention layers: ROADMAP Queue 1 item 11e",
          "attn_cross": "encoder-decoder layers: ROADMAP Queue 1 item 11e",
          "moe": "MoE FFN layers: ROADMAP Queue 1 item 11c"}


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
    p: Dict = {"pre_norm": init_rms(cfg, key.device),
               "attn": attn.init_attn(cfg, k1)}
    if spec.ffn != "none":
        p["post_norm"] = init_rms(cfg, key.device)
        p["ffn"] = init_mlp(cfg, k2)
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
    return x + mlp_apply(cfg, p["ffn"], rms_norm(x, p["post_norm"]))


# ---------------- one superblock ----------------

def superblock_train(cfg: ModelConfig, params_sb: Dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    for i, spec in enumerate(cfg.superblock()):
        p = params_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        x = x + attn.attn_train(cfg, p["attn"], h, positions, causal=causal)
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
    return attn.init_cache(cfg, batch, max_len, dtype, device)


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
        p = params_sb[f"l{i}"]
        o, _ = attn.attn_decode(cfg, p["attn"], rms_norm(x, p["pre_norm"]),
                                pos, cache_sb[f"l{i}"])
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
                       x: torch.Tensor, positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict]:
    for i, spec in enumerate(cfg.superblock()):
        p = params_sb[f"l{i}"]
        o, _ = attn.attn_prefill(cfg, p["attn"], rms_norm(x, p["pre_norm"]),
                                 positions, cache_sb[f"l{i}"])
        x = _ffn(cfg, spec, p, x + o)
    return x, cache_sb


def stack_prefill(cfg: ModelConfig, blocks: Dict, caches: Dict,
                  x: torch.Tensor, positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict]:
    check_ported(cfg)
    for j in range(cfg.num_superblocks):
        x, _ = superblock_prefill(cfg, _index(blocks, j), _index(caches, j),
                                  x, positions)
    return x, caches
