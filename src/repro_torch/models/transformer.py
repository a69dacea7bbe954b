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
and mamba layers and cross-attention layers copy their new state or
memory k/v into the cache's views. Every layer kind runs: self-attention,
mamba, cross attention (``cross_attn``, llama-vision) and self plus cross
attention (``attn_cross``, an encoder-decoder's decoder), with dense or
MoE FFNs. ``stack_encode`` runs an encoder stack at inference through
the ``flash_attention`` kernel (``attn.attn_encode``).
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

def _stack(trees: List[Dict]) -> Dict:
    """The superblocks' trees stacked leaf by leaf. Each leaf's parts are
    dropped from ``trees`` once stacked, so the peak is the parts plus one
    stacked leaf; a single superblock's leaves become views, no copy."""
    out = {}
    for k in list(trees[0]):
        parts = [t.pop(k) for t in trees]
        if isinstance(parts[0], dict):
            out[k] = _stack(parts)
        elif len(parts) == 1:
            out[k] = parts[0].unsqueeze(0)
        else:
            out[k] = torch.stack(parts)
        del parts
    return out


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
    k1, k2, k3 = jr.split(key, 3)
    p: Dict = {"pre_norm": init_rms(cfg, key.device)}
    if spec.kind in ("attn", "cross_attn", "attn_cross"):
        p["attn"] = attn.init_attn(cfg, k1)
        if spec.kind == "attn_cross":
            p["xattn"] = attn.init_attn(cfg, k3)
            p["xnorm"] = init_rms(cfg, key.device)
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


def _ffn(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
         num_groups: int = 1):
    if spec.ffn == "none":
        return x
    h = rms_norm(x, p["post_norm"])
    if spec.ffn == "moe":   # B*S tokens route in num_groups groups
        return x + moe_lib.moe_apply(cfg, p["ffn"], h, num_groups)
    return x + mlp_apply(cfg, p["ffn"], h)


def _write(cache: Dict, new: Dict) -> None:
    """Copy a layer's new state (mamba) or memory k/v (cross attention)
    into its cache's views."""
    for k, v in new.items():
        cache[k].copy_(v)


# ---------------- one superblock ----------------

def superblock_train(cfg: ModelConfig, params_sb: Dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     memory: Optional[torch.Tensor],
                     num_groups: int = 1,
                     causal: bool = True) -> torch.Tensor:
    for i, spec in enumerate(cfg.superblock()):
        p = params_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        if spec.kind in ("attn", "attn_cross"):
            x = x + attn.attn_train(cfg, p["attn"], h, positions,
                                    causal=causal)
            if spec.kind == "attn_cross":
                hx = rms_norm(x, p["xnorm"])
                x = x + attn.attn_train(cfg, p["xattn"], hx, positions,
                                        memory=memory)
        elif spec.kind == "cross_attn":
            x = x + attn.attn_train(cfg, p["attn"], h, positions,
                                    memory=memory)
        else:
            x = x + mb.mamba_apply(cfg, p["mamba"], h)
        x = _ffn(cfg, spec, p, x, num_groups)
    return x


def stack_train(cfg: ModelConfig, blocks: Dict, x: torch.Tensor,
                positions: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                num_groups: int = 1,
                causal: bool = True) -> torch.Tensor:
    """The training forward through every superblock; with ``cfg.remat``
    each superblock's activations are recomputed in the backward. The
    cross-attention ``memory`` goes into each checkpointed superblock as
    an argument, so its grad reaches the encoder."""
    for params_sb in _unbind(blocks, cfg.num_superblocks):
        if cfg.remat:
            x = checkpoint(superblock_train, cfg, params_sb, x, positions,
                           memory, num_groups, causal, use_reentrant=False)
        else:
            x = superblock_train(cfg, params_sb, x, positions, memory,
                                 num_groups, causal)
    return x


def stack_encode(cfg: ModelConfig, blocks: Dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """An encoder stack (self-attention layers only) at inference: each
    layer's bidirectional attention through the ``flash_attention``
    kernel. ``stack_train(..., causal=False)`` computes the same with the
    plain ``attend``. An encoder is dense (``model.encoder_config`` sets
    no experts), so it takes no ``num_groups``."""
    for j in range(cfg.num_superblocks):
        params_sb = _index(blocks, j)
        for i, spec in enumerate(cfg.superblock()):
            p = params_sb[f"l{i}"]
            h = rms_norm(x, p["pre_norm"])
            x = _ffn(cfg, spec, p,
                     x + attn.attn_encode(cfg, p["attn"], h, positions))
    return x


# ---------------- caches ----------------

def _memory_len(cfg: ModelConfig) -> int:
    return (cfg.num_audio_frames if cfg.enc_layers else cfg.num_image_tokens)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device=None) -> Dict:
    if spec.kind == "attn":
        return attn.init_cache(cfg, batch, max_len, dtype, device)
    if spec.kind in ("cross_attn", "attn_cross"):
        # cross-attention k/v over the (image / encoder) memory, filled at
        # prefill and only read at decode
        shape = (batch, _memory_len(cfg), cfg.num_kv_heads, cfg.head_dim)
        c = {"mk": torch.zeros(shape, dtype=dtype, device=device),
             "mv": torch.zeros(shape, dtype=dtype, device=device)}
        if spec.kind == "attn_cross":
            c.update(attn.init_cache(cfg, batch, max_len, dtype, device))
        return c
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
                      x: torch.Tensor, pos: int,
                      num_groups: int = 1) -> Tuple[torch.Tensor, Dict]:
    for i, spec in enumerate(cfg.superblock()):
        p, c = params_sb[f"l{i}"], cache_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        if spec.kind in ("attn", "attn_cross"):
            o, _ = attn.attn_decode(cfg, p["attn"], h, pos, c)
            x = x + o
            if spec.kind == "attn_cross":
                hx = rms_norm(x, p["xnorm"])
                x = x + attn.cross_decode(cfg, p["xattn"], hx,
                                          (c["mk"], c["mv"]))
        elif spec.kind == "cross_attn":
            x = x + attn.cross_decode(cfg, p["attn"], h, (c["mk"], c["mv"]))
        else:
            o, new = mb.mamba_decode(cfg, p["mamba"], h, c)
            _write(c, new)
            x = x + o
        x = _ffn(cfg, spec, p, x, num_groups)
    return x, cache_sb


def stack_decode(cfg: ModelConfig, blocks: Dict, caches: Dict,
                 x: torch.Tensor, pos: int,
                 num_groups: int = 1) -> Tuple[torch.Tensor, Dict]:
    for j in range(cfg.num_superblocks):
        x, _ = superblock_decode(cfg, _index(blocks, j), _index(caches, j),
                                 x, pos, num_groups)
    return x, caches


# ---------------- prefill ----------------

def superblock_prefill(cfg: ModelConfig, params_sb: Dict, cache_sb: Dict,
                       x: torch.Tensor, positions: torch.Tensor,
                       memory: Optional[torch.Tensor],
                       num_groups: int = 1) -> Tuple[torch.Tensor, Dict]:
    """One superblock over the prompt. A cross-attention layer attends
    over the k/v it makes from ``memory`` before they are cast to the
    cache's dtype, as the JAX package does, then copies them into the
    cache."""
    for i, spec in enumerate(cfg.superblock()):
        p, c = params_sb[f"l{i}"], cache_sb[f"l{i}"]
        h = rms_norm(x, p["pre_norm"])
        if spec.kind in ("attn", "attn_cross"):
            o, _ = attn.attn_prefill(cfg, p["attn"], h, positions, c)
            x = x + o
            if spec.kind == "attn_cross":
                mk, mv = attn.memory_kv(cfg, p["xattn"], memory)
                hx = rms_norm(x, p["xnorm"])
                x = x + attn.cross_decode(cfg, p["xattn"], hx, (mk, mv))
                _write(c, {"mk": mk, "mv": mv})
        elif spec.kind == "cross_attn":
            mk, mv = attn.memory_kv(cfg, p["attn"], memory)
            _write(c, {"mk": mk, "mv": mv})
            x = x + attn.cross_decode(cfg, p["attn"], h, (mk, mv))
        else:
            o, new = mb.mamba_prefill(cfg, p["mamba"], h)
            _write(c, new)
            x = x + o
        x = _ffn(cfg, spec, p, x, num_groups)
    return x, cache_sb


def stack_prefill(cfg: ModelConfig, blocks: Dict, caches: Dict,
                  x: torch.Tensor, positions: torch.Tensor,
                  memory: Optional[torch.Tensor] = None,
                  num_groups: int = 1) -> Tuple[torch.Tensor, Dict]:
    for j in range(cfg.num_superblocks):
        x, _ = superblock_prefill(cfg, _index(blocks, j), _index(caches, j),
                                  x, positions, memory, num_groups)
    return x, caches
