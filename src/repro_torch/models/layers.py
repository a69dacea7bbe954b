"""Shared neural building blocks — port of ``repro.models.layers``.

Pure functions over explicit param dicts, as in the JAX package. Params are
float32 (``param_dtype``) and are cast to the compute ``dtype`` where they
are used; initialisers draw from :mod:`repro_torch.random`, so a key gives
the JAX package's params (to the few ulps of ``erf_inv``), on the key's
device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.device import deterministic
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def normal_init(key: torch.Tensor, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype) * scale`` (scale rounded to
    the param type once, as JAX's weak Python scalar)."""
    return jr.normal(key, shape).to(dtype) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale``; returns x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms(cfg: ModelConfig, device=None) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=pdtype_of(cfg), device=device)


# ---------------- rotary embeddings ----------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, dh]; positions broadcastable to [..., S]. Split-halves
    layout: the first dh/2 lanes rotate against the last dh/2."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # [dh/2]
    angles = positions[..., None].float() * freqs             # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------- MLP ----------------

def init_mlp(cfg: ModelConfig, key: torch.Tensor,
             d_ff: int | None = None) -> Dict[str, torch.Tensor]:
    d_ff = d_ff or cfg.d_ff
    pd = pdtype_of(cfg)
    k1, k2, k3 = jr.split(key, 3)
    scale = cfg.d_model ** -0.5
    p = {"down": normal_init(k3, (d_ff, cfg.d_model), d_ff ** -0.5, pd)}
    if cfg.mlp_act == "swiglu":
        p["gate"] = normal_init(k1, (cfg.d_model, d_ff), scale, pd)
    p["up"] = normal_init(k2, (cfg.d_model, d_ff), scale, pd)
    return p


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    up = x @ p["up"].to(dt)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["gate"].to(dt)) * up
    elif cfg.mlp_act == "sq_relu":   # nemotron: squared ReLU
        h = torch.relu(up).square()
    elif cfg.mlp_act == "gelu":      # jax.nn.gelu's default: tanh form
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")
    return h @ p["down"].to(dt)


# ---------------- embeddings / unembedding ----------------

def init_embed(cfg: ModelConfig, key: torch.Tensor) -> Dict[str, torch.Tensor]:
    pd = pdtype_of(cfg)
    k1, k2 = jr.split(key)
    p = {"tok": normal_init(k1, (cfg.vocab, cfg.d_model), 0.02, pd),
         "final_norm": init_rms(cfg, key.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal_init(k2, (cfg.vocab, cfg.d_model),
                                   cfg.d_model ** -0.5, pd)
    return p


class _Rows(torch.autograd.Function):
    """``table[ids]`` whose backward scatter-adds the rows' grads into a
    dense table under deterministic algorithms on the card (the trainer's
    scatters' rule: sorted indices, no racing float atomics)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        g = torch.zeros(ctx.table_shape, dtype=grad.dtype,
                        device=grad.device)
        with deterministic(grad.device):
            g.index_add_(0, ids.reshape(-1),
                         grad.reshape(-1, grad.shape[-1]))
        return g, None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with a deterministic backward on the card."""
    return _Rows.apply(table, ids)


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table, cast to the compute type (gathered first, which
    gives the values of JAX's cast-then-gather; the table's grad is summed
    in float32, where JAX scatters the compute type's)."""
    return take_rows(p["tok"], tokens.long()).to(dtype_of(cfg))


def logits_out(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed; logits in f32 for a stable softmax."""
    x = rms_norm(x, p["final_norm"])
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    return x.float() @ w.float().T


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy. logits [..., V] float32, labels [...]
    int; with ``mask`` the masked sum over ``max(sum(mask), 1)``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom
