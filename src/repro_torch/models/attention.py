"""GQA attention — port of ``repro.models.attention``: training (causal,
sliding-window, bidirectional or cross, through the plain ``attend``
under autograd), prefill through the ``flash_attention`` kernel, the
encoder's bidirectional self-attention at inference through the same
kernel (``attn_encode``), and single-token decode against a KV cache.

Training attends in plain torch, as the JAX package does: its
``attn_train`` calls the plain ``attend`` (no Pallas kernel, and no
backward kernel in either package), so autograd of the same ops gives the
backward. Cross attention (``memory=``, ``memory_kv``, ``cross_decode``)
is the plain ``attend`` too, as in the JAX package: its q and k have
different lengths, which the kernel (one S for q and k) does not take.
Cache layout: k/v [B, S_max, KV, dh]. Sliding-window archs
(mixtral) keep a ring buffer of ``min(max_len, window)`` slots: prefill
writes the last ``window`` positions at their slots ``pos % s_cache`` and
decode writes position ``pos`` at slot ``pos % s_cache``, as the JAX
package does. Where JAX returns updated copies, the port writes the caches
in place and returns them. The JAX package's sharding hints
(``actsharding``, the ``optflags.SEQ_DECODE`` score layout) leave one
device's arithmetic unchanged and have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as jr
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, normal_init, pdtype_of


def init_attn(cfg: ModelConfig, key: torch.Tensor) -> Dict[str, torch.Tensor]:
    pd = pdtype_of(cfg)
    k1, k2, k3, k4 = jr.split(key, 4)
    s = cfg.d_model ** -0.5
    return {
        "wq": normal_init(k1, (cfg.d_model, cfg.num_heads, cfg.head_dim), s,
                          pd),
        "wk": normal_init(k2, (cfg.d_model, cfg.num_kv_heads, cfg.head_dim),
                          s, pd),
        "wv": normal_init(k3, (cfg.d_model, cfg.num_kv_heads, cfg.head_dim),
                          s, pd),
        "wo": normal_init(k4, (cfg.num_heads, cfg.head_dim, cfg.d_model),
                          (cfg.num_heads * cfg.head_dim) ** -0.5, pd),
    }


def _check_softcap(cfg: ModelConfig) -> None:
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            f"attn_logit_softcap={cfg.attn_logit_softcap}: no config uses a "
            f"logit softcap and the flash_attention kernel has none")


def _expand_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, KV, dh] -> [B, S, KV*q_per_kv, dh] by repeat (GQA)."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Skv,H,dh] -> [B,Sq,H,dh]; f32 softmax. As in
    the JAX package, the scores come back in q's dtype before the cast to
    float32 and the probabilities are cast to q's dtype for the weighted
    sum (in bf16 this rounds where the flash kernel does not)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mask_bias(sq: int, skv: int, causal: bool, window: int,
               q_offset: int = 0, device=None) -> torch.Tensor:
    """[sq, skv] float32 additive mask: 0 where query i may see key j,
    ``NEG_INF`` elsewhere (causal: j <= i + q_offset; window: j > i +
    q_offset - window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).float()


def _project(p: Dict, x: torch.Tensor, name: str) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bshk", x, p[name].to(x.dtype))


def _out(p: Dict, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def attn_train(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True,
               window: Optional[int] = None,
               memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention for training: RoPE on q and k, the causal /
    sliding-window mask (``window`` overrides ``cfg.window``; 0 is none),
    GQA by repeating k/v, the plain ``attend``; differentiable by
    autograd. ``memory`` [B, M, D] switches to cross attention: k and v
    from the memory, no RoPE and no mask."""
    _check_softcap(cfg)
    q = _project(p, x, "wq")
    src = x if memory is None else memory
    k, v = _project(p, src, "wk"), _project(p, src, "wv")
    bias = None
    if memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        win = cfg.window if window is None else window
        bias = _mask_bias(x.shape[1], x.shape[1], causal, win,
                          device=x.device)
    o = attend(q, _expand_kv(k, cfg.q_per_kv), _expand_kv(v, cfg.q_per_kv),
               bias)
    return _out(p, o)


# ---------------- decode with KV cache ----------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None) -> Dict[str, torch.Tensor]:
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, pos: int,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x [B, 1, D]; pos the current position (an int).
    Writes k/v of ``pos`` into the cache in place (ring slot ``pos %
    s_cache`` for sliding-window archs) and attends over the valid slots,
    in plain torch as the JAX package does outside any kernel."""
    _check_softcap(cfg)
    pos = int(pos)
    dev = x.device
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=dev)
    q = apply_rope(_project(p, x, "wq"), positions, cfg.rope_theta)
    k_new = apply_rope(_project(p, x, "wk"), positions, cfg.rope_theta)
    v_new = _project(p, x, "wv")
    k, v = cache["k"], cache["v"]
    s_cache = k.shape[1]
    slot = pos % s_cache if cfg.window else pos
    if slot >= s_cache:
        raise ValueError(f"position {pos} is past the cache's {s_cache} "
                         f"slots")
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    # valid positions: <= pos (ring buffer: all slots written once full)
    kpos = torch.arange(s_cache, device=dev)
    valid = (kpos <= slot) | (pos >= s_cache) if cfg.window else \
        kpos <= pos
    bias = torch.where(valid, 0.0, NEG_INF).float()[None, None, None]
    o = attend(q, _expand_kv(k, cfg.q_per_kv), _expand_kv(v, cfg.q_per_kv),
               bias)
    return _out(p, o), cache


def prefill_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor):
    """q [B,S,H,dh], k, v [B,S,KV,dh] of a prompt, RoPE applied to q and
    k: the flash kernel's inputs at one prefill layer."""
    q = apply_rope(_project(p, x, "wq"), positions, cfg.rope_theta)
    k = apply_rope(_project(p, x, "wk"), positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), \
        _project(p, x, "wv").contiguous()


def attn_prefill(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence causal (sliding-window) self-attention through the
    ``flash_attention`` kernel (its plain version for CPU tensors); fills
    the KV cache in place (SWA: the last ``s_cache`` entries at their ring
    slots)."""
    _check_softcap(cfg)
    s = x.shape[1]
    q, k, v = prefill_qkv(cfg, p, x, positions)
    out = _out(p, flash_attention(q, k, v, window=cfg.window, causal=True))
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    if cfg.window and s > s_cache:
        slots = torch.arange(s - s_cache, s, device=x.device) % s_cache
        ck[:, slots] = k[:, -s_cache:].to(ck.dtype)
        cv[:, slots] = v[:, -s_cache:].to(cv.dtype)
    else:
        n = min(s, s_cache)
        ck[:, :n] = k[:, :n].to(ck.dtype)
        cv[:, :n] = v[:, :n].to(cv.dtype)
    return out, cache


def attn_encode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """An encoder layer's bidirectional self-attention at inference: q, k
    and v as ``prefill_qkv`` makes them, through the ``flash_attention``
    kernel with ``causal=False`` (its plain version for CPU tensors); no
    cache. ``attn_train(..., causal=False)`` computes the same."""
    _check_softcap(cfg)
    q, k, v = prefill_qkv(cfg, p, x, positions)
    return _out(p, flash_attention(q, k, v, window=cfg.window, causal=False))


def cross_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 memory_kv: Tuple[torch.Tensor, torch.Tensor]
                 ) -> torch.Tensor:
    """Cross attention of x [B, S, D] over k/v [B, M, KV, dh] made from the
    encoder / vision memory once at prefill (``memory_kv``): no RoPE, no
    mask, the plain ``attend``."""
    _check_softcap(cfg)
    k, v = memory_kv
    o = attend(_project(p, x, "wq"), _expand_kv(k, cfg.q_per_kv),
               _expand_kv(v, cfg.q_per_kv), None)
    return _out(p, o)


def memory_kv(cfg: ModelConfig, p: Dict, memory: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k, v [B, M, KV, dh] of a memory [B, M, D], in the memory's dtype."""
    return _project(p, memory, "wk"), _project(p, memory, "wv")
