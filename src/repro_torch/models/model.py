"""Top-level model API — port of ``repro.models.model``.

    params            = init_params(cfg, key, device)
    loss              = loss_fn(cfg, params, batch)           (train)
    logits, caches    = prefill(cfg, params, batch, max_len)
    logits, caches    = serve_step(cfg, params, token, pos, caches)

``batch`` is ``{"tokens": [B, S] int}``, for training with ``"labels"``
[B, S] and an optional ``"mask"``. Everything runs on the params' device;
the caches are written in place. Training is differentiable by autograd
(``optim.grad_utils.value_and_grad``); prefill's self-attention goes
through the ``flash_attention`` kernel on the card. Encoder-decoder and VLM
inputs (``frames``, ``patches``) come with the cross-attention slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dtype_of, embed_tokens, init_embed,
                                       logits_out, softmax_xent)


def init_params(cfg: ModelConfig, key: torch.Tensor, device=None) -> Dict:
    """The JAX package's ``init_params(cfg, key)`` on ``device`` (the card
    unless the caller names the CPU): float32 params, stacked [NSB, ...]
    per pattern position."""
    key = key.to(resolve_device(device))
    k_embed, k_blocks, _ = jr.split(key, 3)
    return {"embed": init_embed(cfg, k_embed),
            "blocks": tf.init_blocks(cfg, k_blocks)}


# ---------------- train ----------------

def forward_train(cfg: ModelConfig, params: Dict,
                  batch: Dict) -> torch.Tensor:
    """Logits [B, S, V] float32 of every position."""
    for name in ("frames", "patches"):
        if name in batch:
            raise NotImplementedError(
                f"{name!r} inputs (encoder-decoder / VLM memory): ROADMAP "
                f"Queue 1 item 11e (not ported yet)")
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    x = tf.stack_train(cfg, params["blocks"], x, positions)
    return logits_out(cfg, params["embed"], x)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Token-mean cross entropy of ``forward_train``'s logits against
    ``batch["labels"]`` (masked by ``batch["mask"]`` when given)."""
    logits = forward_train(cfg, params, batch)
    mask = batch.get("mask")
    return softmax_xent(
        logits, torch.as_tensor(batch["labels"], device=logits.device),
        None if mask is None else torch.as_tensor(mask, device=logits.device))


# ---------------- inference ----------------

def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Run the full prompt, returning (last-token logits [B, V] float32,
    filled caches)."""
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    b, s = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(s, device=dev)
    caches = tf.init_caches(cfg, b, max_len, dtype_of(cfg), dev)
    x, caches = tf.stack_prefill(cfg, params["blocks"], caches, x, positions)
    logits = logits_out(cfg, params["embed"], x[:, -1:])
    return logits[:, 0], caches


def serve_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
               pos: int, caches: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token [B] int, pos the position it takes (an int)
    -> (logits [B, V] float32, the caches, updated in place)."""
    dev = params["embed"]["tok"].device
    x = embed_tokens(cfg, params["embed"],
                     torch.as_tensor(token, device=dev)[:, None])
    x, caches = tf.stack_decode(cfg, params["blocks"], caches, x, pos)
    logits = logits_out(cfg, params["embed"], x)
    return logits[:, 0], caches
