"""Assigned input-shape sets and the smoke-config reduction — a copy of
``repro.configs.base``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

# LM-family shapes (assignment): name -> (seq_len, global_batch, step kind)
SHAPES: Dict[str, dict] = {
    "train_4k":    {"seq": 4_096,   "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32_768,  "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32_768,  "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524_288, "batch": 1,   "kind": "decode"},
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k needs a sub-quadratic decode path (ssm/hybrid/SWA);
    full-attention archs skip it."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention: 512k-token KV decode is "
                       "intentionally skipped (DESIGN.md §5)")
    return True, ""


def smoke_reduce(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: identical block
    pattern, tiny widths."""
    pattern = len(cfg.superblock())
    return dataclasses.replace(
        cfg,
        num_layers=pattern * min(2, cfg.num_superblocks),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 // max(1, cfg.q_per_kv)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        moe_experts=min(cfg.moe_experts, 4),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16,
        ssm_expand=2,
        enc_layers=2 if cfg.enc_layers else 0,
        num_image_tokens=16,
        num_audio_frames=16,
        window=min(cfg.window, 8) if cfg.window else 0,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
