"""Top-level model API — port of ``repro.models.model``.

    params            = init_params(cfg, key, device)
    loss              = loss_fn(cfg, params, batch)           (train)
    logits, caches    = prefill(cfg, params, batch, max_len)
    logits, caches    = serve_step(cfg, params, token, pos, caches)

``batch`` is ``{"tokens": [B, S] int}``, for training with ``"labels"``
[B, S] and an optional ``"mask"``; an encoder-decoder config adds
``"frames"`` [B, Ta, D] and a VLM ``"patches"`` [B, Ni, D] (the
frontends are stubs: precomputed frame or patch embeddings, cast to the
compute dtype). Everything runs on the params' device; the caches are
written in place. Training is differentiable by autograd
(``optim.grad_utils.value_and_grad``), the encoder included; prefill's
self-attention, the encoder's bidirectional one among it, goes through
the ``flash_attention`` kernel on the card; cross attention, mamba and
MoE layers are plain torch, as in the JAX package (no Pallas kernel
there), and the MoE layers route all B*S tokens as one group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
    k_embed, k_blocks, k_enc = jr.split(key, 3)
    params = {"embed": init_embed(cfg, k_embed),
              "blocks": tf.init_blocks(cfg, k_blocks)}
    if cfg.enc_layers:
        params["encoder"] = tf.init_blocks(encoder_config(cfg), k_enc)
    return params


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack of an enc-dec model: bidirectional dense layers."""
    return dataclasses.replace(
        cfg, num_layers=cfg.enc_layers, attn_every=1, cross_every=0,
        moe_experts=0, moe_every=0, enc_layers=0)


def _memory(cfg: ModelConfig, params: Dict, batch: Dict,
            train: bool) -> Optional[torch.Tensor]:
    """Cross-attention memory: the encoder's output (encdec) or the patch
    embeddings (vlm), in the compute dtype. The encoder runs as
    ``stack_train(..., causal=False)`` in training (the plain ``attend``
    under autograd) and through the ``flash_attention`` kernel
    (``stack_encode``) at inference."""
    dev = params["embed"]["tok"].device
    if cfg.enc_layers:
        frames = torch.as_tensor(batch["frames"], device=dev).to(
            dtype_of(cfg))
        pos = torch.arange(frames.shape[1], device=dev)
        enc_cfg = encoder_config(cfg)
        if train:
            return tf.stack_train(enc_cfg, params["encoder"], frames, pos,
                                  causal=False)
        return tf.stack_encode(enc_cfg, params["encoder"], frames, pos)
    if cfg.cross_every:
        return torch.as_tensor(batch["patches"], device=dev).to(
            dtype_of(cfg))
    return None


def zero_memory(cfg: ModelConfig, batch: int, device=None) -> Dict:
    """The JAX launchers' and examples' stand-in memory: float32 zero
    ``frames`` [batch, num_audio_frames, D] for an encoder-decoder config,
    zero ``patches`` [batch, num_image_tokens, D] for a VLM, else none.
    (Zero memory leaves the cross layers inert: zero frames encode to 0
    and zero patches give zero k and v.)"""
    out = {}
    if cfg.enc_layers:
        out["frames"] = torch.zeros((batch, cfg.num_audio_frames,
                                     cfg.d_model), device=device)
    if cfg.cross_every and not cfg.enc_layers:
        out["patches"] = torch.zeros((batch, cfg.num_image_tokens,
                                      cfg.d_model), device=device)
    return out


# ---------------- train ----------------

def forward_train(cfg: ModelConfig, params: Dict,
                  batch: Dict) -> torch.Tensor:
    """Logits [B, S, V] float32 of every position."""
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    memory = _memory(cfg, params, batch, train=True)
    x = tf.stack_train(cfg, params["blocks"], x, positions, memory=memory)
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
    memory = _memory(cfg, params, batch, train=False)
    caches = tf.init_caches(cfg, b, max_len, dtype_of(cfg), dev)
    x, caches = tf.stack_prefill(cfg, params["blocks"], caches, x, positions,
                                 memory=memory)
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
