"""Architecture configuration for the model zoo — a copy of
``repro.models.config`` (the port imports nothing of the JAX package).

One frozen dataclass covers all 10 assigned families; the block layout is
expressed as a *superblock pattern* (list of layer descriptors) repeated
``num_layers / len(pattern)`` times. The port runs the superblocks in a
Python loop where the JAX package scans them: ``scan_layers`` is kept so
configs compare field for field and changes nothing here; ``remat``
recomputes each superblock's activations in training's backward
(``torch.utils.checkpoint``), which changes no value.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a superblock."""
    kind: str          # "attn" | "mamba" | "cross_attn"
    ffn: str           # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    mlp_act: str = "swiglu"     # swiglu | sq_relu | gelu
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 0          # within a superblock: layer i is MoE if
                                # moe_every and i % moe_every == moe_phase
    moe_phase: int = 0
    capacity_factor: float = 1.25
    # --- attention ---
    window: int = 0             # sliding-window size; 0 = full causal
    rope_theta: float = 1e4
    attn_logit_softcap: float = 0.0
    # --- hybrid / ssm ---
    attn_every: int = 1         # 1 = all attn; 8 = jamba (1 attn per 8);
                                # 0 = attention-free (mamba)
    attn_offset: int = 4        # index of the attn layer inside the period
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # --- enc-dec ---
    enc_layers: int = 0         # >0 => encoder-decoder (num_layers = decoder)
    # --- vlm ---
    cross_every: int = 0        # period of cross-attn layers (llama-vision 5)
    num_image_tokens: int = 1600
    num_audio_frames: int = 1024
    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True    # False: unroll superblocks (used by the
                                # dry-run cost extrapolation; see roofline)
    tie_embeddings: bool = False
    # long-context capability marker (sub-quadratic decode path exists)
    subquadratic: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def superblock(self) -> Tuple[LayerSpec, ...]:
        """The repeating layer pattern."""
        period = (self.attn_every if self.attn_every > 1 else
                  (self.cross_every if self.cross_every else 1))
        specs = []
        for i in range(period):
            if self.attn_every == 0:
                kind = "mamba"
            elif self.attn_every == 1:
                kind = "attn"
            else:  # hybrid: one attn layer per period at attn_offset
                kind = "attn" if i == self.attn_offset % period else "mamba"
            if self.enc_layers and self.cross_every == 1:
                kind = "attn_cross"  # enc-dec decoder: self + cross per layer
            elif self.cross_every and i == period - 1:
                kind = "cross_attn"
            if self.family == "ssm":
                ffn = "none"
            elif self.moe_experts and (self.moe_every == 1 or (
                    self.moe_every and i % self.moe_every == self.moe_phase)):
                ffn = "moe"
            else:
                ffn = "dense"
            specs.append(LayerSpec(kind=kind, ffn=ffn))
        assert self.num_layers % len(specs) == 0, (self.num_layers, specs)
        return tuple(specs)

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // len(self.superblock())

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        n = 0
        v_embed = self.vocab * self.d_model
        n += v_embed * (1 if self.tie_embeddings else 2)
        for spec in self.superblock():
            n_layer = 0
            if spec.kind in ("attn", "cross_attn", "attn_cross"):
                qkv = self.d_model * self.head_dim * (
                    self.num_heads + 2 * self.num_kv_heads)
                out = self.num_heads * self.head_dim * self.d_model
                n_layer += qkv + out
                if spec.kind == "attn_cross":  # second (cross) attention
                    n_layer += qkv + out
            if spec.kind == "mamba":
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                # in_proj: z, x, B, C, dt ; out_proj
                n_layer += self.d_model * (2 * di + 2 * ds + nh)
                n_layer += di * self.d_model
                n_layer += self.ssm_conv * (di + 2 * ds)
            if spec.ffn == "dense":
                mats = 3 if self.mlp_act == "swiglu" else 2
                n_layer += mats * self.d_model * self.d_ff
            elif spec.ffn == "moe":
                mats = 3 if self.mlp_act == "swiglu" else 2
                n_layer += (self.moe_experts * mats * self.d_model * self.d_ff
                            + self.d_model * self.moe_experts)
            n_layer += 2 * self.d_model  # norms
            n += n_layer * self.num_superblocks
        if self.enc_layers:
            enc = self.enc_layers * (
                self.d_model * self.head_dim * (self.num_heads +
                                                2 * self.num_kv_heads)
                + self.num_heads * self.head_dim * self.d_model
                + (3 if self.mlp_act == "swiglu" else 2) * self.d_model *
                self.d_ff + 2 * self.d_model)
            n += enc
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of experts), for 6·N_active·D."""
        if not self.moe_experts:
            return self.param_count()
        full = self.param_count()
        mats = 3 if self.mlp_act == "swiglu" else 2
        moe_layers = sum(1 for s in self.superblock()
                         if s.ffn == "moe") * self.num_superblocks
        expert_params = moe_layers * self.moe_experts * mats * \
            self.d_model * self.d_ff
        active = moe_layers * self.moe_top_k * mats * self.d_model * self.d_ff
        return full - expert_params + active
