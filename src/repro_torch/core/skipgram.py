"""Skip-gram with negative sampling (SGNS), Node2Vec stage 2 — port of
``repro.core.skipgram``.

    L = -log sigma(u_c . v_p) - sum_k log sigma(-u_c . v_nk)

Parameters are a dict of two ``[V, D]`` tables, ``emb_in`` and
``emb_out``. :func:`sgns_grads` has the JAX package's two backends:

* ``"jnp"`` (the name is kept) — autograd through :func:`sgns_loss`, the
  reference;
* ``"fused"`` — the fused kernel's table entry
  (``repro_torch.kernels.sgns.sgns_fused_tables``: on the card the CUDA
  kernel, which reads the rows in place, on the CPU its plain version)
  gives the row grads already divided by the batch's divisor; they are
  scatter-added into the tables.

On the card both backends scatter with deterministic algorithms (sorted
indices, no float atomics), so a run repeats bit for bit; the setting is
switched on only around the scatter.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.kernels.sgns import sgns_fused_tables
from repro_torch.optim.optimizers import Optimizer, apply_updates

SGNS_BACKENDS = ("jnp", "fused")


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    vocab: int
    dim: int = 128
    negatives: int = 5
    param_dtype: Any = torch.float32


def init_params(cfg: SGNSConfig, key: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """``emb_in = (uniform(k1, (V, D)) - 0.5) * 2 * (1 / sqrt(D))`` in
    float32, in the JAX package's order of operations (bit-exact with it),
    ``emb_out = 0``; the tables live on ``key``'s device."""
    k1 = jr.split(key)[0]
    dev = key.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(cfg.dim), dtype=torch.float32,
                                          device=dev))
    u = jr.uniform(k1, (cfg.vocab, cfg.dim)).to(cfg.param_dtype)
    return {"emb_in": (u - 0.5) * 2 * scale.to(cfg.param_dtype),
            "emb_out": torch.zeros((cfg.vocab, cfg.dim), dtype=cfg.param_dtype,
                                   device=dev)}


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -torch.logaddexp(torch.zeros((), dtype=x.dtype, device=x.device),
                            -x)


def sgns_loss(params, center: torch.Tensor, pos: torch.Tensor,
              negs: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Batch SGNS loss. center/pos: [B]; negs: [B, K]; valid: [B] mask.
    Elementwise products and sums only (no matrix product), so it runs
    under deterministic algorithms on the card."""
    ci = params["emb_in"][center]            # [B, D]
    po = params["emb_out"][pos]              # [B, D]
    no = params["emb_out"][negs]             # [B, K, D]
    pos_score = (ci * po).sum(-1)
    neg_score = (no * ci[:, None, :]).sum(-1)
    per = -(log_sigmoid(pos_score) + log_sigmoid(-neg_score).sum(-1))
    if valid is None:
        return per.mean()
    denom = torch.clamp(valid.sum(), min=1.0)
    return (per * valid).sum() / denom


@contextlib.contextmanager
def _deterministic(device: torch.device):
    """Deterministic algorithms on the card for the enclosed ops (scatter-
    adds sort their indices instead of racing float atomics)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def sgns_grads(params, batch, backend: str = "jnp"):
    """Loss and parameter gradients (dense ``[V, D]`` tables) for one SGNS
    batch: ``center``/``pos`` [B], ``neg`` [B, K], optional ``valid`` [B]."""
    center = batch["center"].long()
    pos = batch["pos"].long()
    negs = batch["neg"].long()
    valid = batch.get("valid")
    dev = params["emb_in"].device
    if backend == "jnp":
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with _deterministic(dev), torch.enable_grad():
            loss = sgns_loss(leaves, center, pos, negs, valid)
            g_in, g_out = torch.autograd.grad(
                loss, (leaves["emb_in"], leaves["emb_out"]))
        return loss.detach(), {"emb_in": g_in, "emb_out": g_out}
    if backend != "fused":
        raise ValueError(
            f"sgns backend must be one of {SGNS_BACKENDS}, got {backend!r}")
    v = torch.ones(center.shape[0], dtype=torch.float32, device=dev) \
        if valid is None else valid.to(torch.float32)
    # the kernel reads the rows in place and returns the masked *sum* over
    # denom: the jnp path trains on the masked mean, so both backends see
    # one gradient
    denom = torch.clamp(v.sum(), min=1.0)
    loss, g_ci, g_po, g_no = sgns_fused_tables(
        params["emb_in"], params["emb_out"], _int32(batch["center"]),
        _int32(batch["pos"]), _int32(batch["neg"]), v, denom)
    d = g_ci.shape[1]
    with _deterministic(dev):
        g_in = torch.zeros_like(params["emb_in"]).index_add_(0, center, g_ci)
        g_out = (torch.zeros_like(params["emb_out"])
                 .index_add_(0, pos, g_po)
                 .index_add_(0, negs.reshape(-1), g_no.reshape(-1, d)))
    return loss, {"emb_in": g_in, "emb_out": g_out}


def _int32(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int32).contiguous()


def train_step(params, opt_state, batch, opt: Optimizer,
               backend: str = "jnp"):
    """One SGNS step: grads, optimizer update, new params (new tensors;
    nothing is updated in place)."""
    loss, grads = sgns_grads(params, batch, backend)
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss


def normalize_embeddings(params) -> torch.Tensor:
    e = params["emb_in"].to(torch.float32)
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)


def serving_table(params) -> np.ndarray:
    """The train -> serve handoff: host float32 unit-norm ``[V, D]``."""
    return normalize_embeddings(params).cpu().numpy()
