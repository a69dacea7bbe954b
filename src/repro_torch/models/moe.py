"""Mixture-of-Experts FFN with grouped local routing — port of
``repro.models.moe``.

Tokens are reshaped to [G, Tg, D] routing groups; routing, capacity
selection and dispatch are local to a group. Per expert, the C highest
scored of its assigned tokens (C the capacity) are gathered into a dense
[G, E, C, D] batch, fed through batched expert GEMMs and scatter-added back
weighted by their router probabilities. Tokens past an expert's capacity
drop (the residual passes them through), as in the JAX package.

Both of JAX's ``lax.top_k`` calls (k experts per token, C tokens per
expert) choose integers and put equal values at the lower index first;
``torch.topk`` promises no order among ties, so :func:`top_k` is a stable
descending sort. Unassigned tokens all score -1 and tie, so that order
decides which of them fill an expert's empty slots (at weight zero). The
scatter-add, and in training the gather's backward, run under
deterministic algorithms on the card (``device.deterministic``), as the
embedding's do. The JAX package's sharding hints
(``actsharding.constrain_weight``) are TPU layout only and have no
counterpart here.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.device import deterministic
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (mlp_apply, normal_init, pdtype_of,
                                       take_rows)


def init_moe(cfg: ModelConfig, key: torch.Tensor) -> Dict[str, torch.Tensor]:
    pd = pdtype_of(cfg)
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    ks = jr.split(key, 4)
    p = {"router": normal_init(ks[0], (d, e), d ** -0.5, pd),
         "down": normal_init(ks[1], (e, f, d), f ** -0.5, pd),
         "up": normal_init(ks[2], (e, d, f), d ** -0.5, pd)}
    if cfg.mlp_act == "swiglu":
        p["gate"] = normal_init(ks[3], (e, d, f), d ** -0.5, pd)
    return p


def top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, equal values
    in ascending index order (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, tg: int) -> int:
    """Tokens an expert takes per group of ``tg``, in Python floats as the
    JAX package computes it."""
    cap = max(1, int(tg * cfg.moe_top_k / cfg.moe_experts *
                     cfg.capacity_factor))
    return min(cap, tg)


class Routing(NamedTuple):
    top_e: torch.Tensor       # [G, Tg, k] int64, each token's experts
    weight_te: torch.Tensor   # [G, Tg, E] float32, 0 where not assigned
    sel_idx: torch.Tensor     # [G, E, C] int64, each expert's token slots
    sel_valid: torch.Tensor   # [G, E, C] bool, slot holds an assigned token


def route(cfg: ModelConfig, p: Dict, xg: torch.Tensor) -> Routing:
    """Router and capacity selection of ``xg`` [G, Tg, D]: the logits in
    ``xg``'s dtype, softmax and renorm in float32, each token's top k
    experts, then each expert's top C tokens by score (the router weight
    if assigned, else -1)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = capacity(cfg, xg.shape[1])
    logits = torch.einsum("gtd,de->gte", xg, p["router"].to(xg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    assign = F.one_hot(top_e, e).float()                    # [G,Tg,k,E]
    weight_te = torch.einsum("gtke,gtk->gte", assign, top_p)
    score = torch.where(weight_te > 0, weight_te, -1.0)
    sel_score, sel_idx = top_k(score.transpose(1, 2), cap)  # [G,E,C]
    return Routing(top_e, weight_te, sel_idx, sel_score > 0)


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              num_groups: int) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]. ``num_groups`` must divide B*S."""
    b, s, d = x.shape
    g = num_groups
    if (b * s) % g:
        raise ValueError(f"num_groups={g} does not divide {b * s} tokens")
    tg = b * s // g
    xg = x.reshape(g, tg, d)
    r = route(cfg, p, xg)
    e, cap = r.sel_idx.shape[1:]
    # the group's token slots as rows of the flattened [G * Tg, D] tokens,
    # expert-major (e * cap + c) within each group, as JAX's scatter adds
    rows = (r.sel_idx + torch.arange(g, device=x.device)[:, None, None]
            * tg).reshape(-1)
    xe = take_rows(x.reshape(g * tg, d), rows).reshape(g, e, cap, d)
    # each expert's FFN: [G, E, C, D] @ [E, D, F] broadcasts over G, the
    # einsums gecd,edf->gecf and gecf,efd->gecd of the JAX package
    ye = mlp_apply(cfg, p, xe)
    wsel = r.weight_te.transpose(1, 2).gather(2, r.sel_idx)
    ye = ye * (wsel * r.sel_valid)[..., None].to(ye.dtype)
    with deterministic(x.device):
        out = torch.zeros((g * tg, d), dtype=x.dtype,
                          device=x.device).index_add(
            0, rows, ye.reshape(-1, d))
    return out.reshape(b, s, d)
