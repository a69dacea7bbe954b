"""Analytic per-device traffic — port of ``repro.roofline.traffic``.

Walk half: the NEIG exchange's bytes follow from its shapes,
``walk_auto_capacity`` sizes the exchange from the degree distribution,
and ``walk_overlap_model`` estimates how much of the pipelined walk's
exchange can hide behind the other cohort's sampling.

LM half (``analytic_bytes``, ``param_bytes_per_device``): the per-device
HBM bytes of one train, prefill or decode step on a ``data x model``
(x ``pod``) mesh, the JAX package's napkin math term for term:

train (per device, per step):
  weights    3 compute passes (fwd, remat-fwd, bwd) x param_bytes
  optimizer  7 x param_bytes (read p/m/v/g, write p/m/v) + 2 x grad
  acts       L x tokens_dev x d_model x bf16 x C   (C ~ 16 streams r+w)
  attn S^2   per attention layer: B_dev x H_dev x S x W x ~12 bytes
             (f32 logits w+r, bf16 probs w+r), W = min(S, window)
             -- dropped with ``flash_attention=True``.
decode (per device, per step):
  weights    1 x param_bytes (every live weight read once)
  kv/state   cache bytes read (+ epsilon write)

Every hardware constant of the port lives here, and they are one NVIDIA
H100 SXM 80GB's data-sheet figures (at its 700 W limit): the rates the
overlap model and ``roofline.analysis`` divide by. Nothing here is a
measurement, and none of it gates a result.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.models.config import ModelConfig

BF16 = 2
F32 = 4
H100_BF16_FLOPS = 989e12    # dense bfloat16 on the tensor cores
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores
H100_HBM_BW = 3.35e12       # bytes/s of device memory
H100_NVLINK_BW = 450e9      # bytes/s one way (900 GB/s both ways)


def walk_exchange_bytes(num_shards: int, capacity: int, cap: int,
                        w_bytes: int = F32) -> int:
    """Per-device bytes of ONE two-phase NEIG exchange: the request buffer
    (S x C x 4B ids out) plus the response rows (S x C x cap x (4B ids +
    w_bytes weights))."""
    return num_shards * capacity * (4 + cap * (4 + w_bytes))


def walk_collective_bytes(num_shards: int, capacity: int, cap: int,
                          length: int, w_bytes: int = F32) -> int:
    """Per-device NEIG-exchange bytes of one barrier-mode walk: one
    exchange per superstep after step 0, which is local."""
    per_step = walk_exchange_bytes(num_shards, capacity, cap, w_bytes)
    return per_step * max(length - 1, 0)


def sgns_exchange_bytes(u_rows: int, dim: int, num_shards: int,
                        w_bytes: int = F32) -> int:
    """Per-device collective bytes of one sharded SGNS step: the
    ``u_rows x dim`` owner-gather buffers through a ring all-reduce,
    ``2·(S−1)/S·u_rows·dim·4``; 0 at one shard."""
    if num_shards <= 1:
        return 0
    return int(2 * (num_shards - 1) / num_shards * u_rows * dim * w_bytes)


def walk_auto_capacity(deg, cap: Optional[int], num_shards: int,
                       walkers_per_shard: int, safety: float = 4.0,
                       floor: int = 8) -> int:
    """Per-destination exchange capacity from the degree distribution
    (``WalkPlan.capacity="auto"``).

    Only cold remote vertices take request slots, and a walk stands on a
    vertex in proportion to its degree, so the expected per-destination
    demand is ``walkers_per_shard · cold_share / num_shards`` with
    ``cold_share = sum(deg[deg <= cap]) / sum(deg)`` (1 without a hot
    set). ``safety`` covers bursts, ``floor`` tiny shards; the result never
    exceeds ``walkers_per_shard`` (the zero-drop default)."""
    deg = np.asarray(deg, np.float64)
    total = deg.sum()
    if total <= 0 or num_shards < 1:
        return max(min(floor, walkers_per_shard), 1)
    cold_share = deg[deg <= cap].sum() / total if cap is not None else 1.0
    expected = walkers_per_shard * cold_share / num_shards
    auto = int(np.ceil(safety * expected))
    auto = max(auto, min(floor, walkers_per_shard), 1)
    return min(auto, walkers_per_shard)


def walk_step_flops(walkers: int, width: int) -> float:
    """Sampling operations of one superstep: the membership test
    (width x width a walker) plus O(width) lanes of probabilities, scan
    and count."""
    return float(walkers) * (float(width) * float(width) + 8.0 * width)


def walk_step_bytes(walkers: int, width: int) -> float:
    """Device-memory bytes of one superstep's sampling: the membership
    booleans plus ~6 float32 streams a walker."""
    return float(walkers) * (float(width) * float(width) + 24.0 * width)


def walk_overlap_model(num_shards: int, capacity: int, cap: int, length: int,
                       walkers_per_shard: int, pipeline: bool,
                       w_bytes: int = F32, width: Optional[int] = None,
                       peak_flops: Optional[float] = None,
                       hbm_bw: Optional[float] = None,
                       link_bw: Optional[float] = None) -> dict:
    """Exposed-vs-total exchange bytes of one walk.

    Barrier mode: every exchange is on the superstep's critical path.
    Pipelined mode (two cohorts, ``core.walk_distributed``): each exchange
    can hide behind the other cohort's step, ``max(0, e - t · link_bw)``
    exposed, with ``t`` the larger of the hiding cohort's operation and
    memory times; cohort A's first exchange hides behind nothing.

    Returns ``{"total_bytes", "exposed_bytes", "efficiency"}``,
    ``efficiency = 1 - exposed / total`` (0 with nothing on the wire)."""
    peak_flops = peak_flops or H100_F32_FLOPS
    hbm_bw = hbm_bw or H100_HBM_BW
    link_bw = link_bw or H100_NVLINK_BW
    width = width or cap
    steps = max(length - 1, 0)
    if steps == 0 or num_shards <= 1:
        return {"total_bytes": 0, "exposed_bytes": 0, "efficiency": 0.0}
    e = walk_exchange_bytes(num_shards, capacity, cap, w_bytes)
    if not pipeline:
        return {"total_bytes": e * steps, "exposed_bytes": e * steps,
                "efficiency": 0.0}
    w_a = (walkers_per_shard + 1) // 2          # cohort A = ceil half
    w_b = walkers_per_shard - w_a

    def hide(w):
        t = max(walk_step_flops(w, width) / peak_flops,
                walk_step_bytes(w, width) / hbm_bw)
        return t * link_bw

    hide_a, hide_b = hide(w_a), hide(w_b)
    total = e * (2 * steps)
    exposed = e \
        + (steps - 1) * max(0.0, e - hide_b) \
        + steps * max(0.0, e - hide_a)
    return {"total_bytes": int(total), "exposed_bytes": int(exposed),
            "efficiency": 1.0 - exposed / total if total else 0.0}


def _shards(mesh_shape: dict) -> tuple[int, int, int]:
    pod = mesh_shape.get("pod", 1)
    data = mesh_shape.get("data", 1)
    model = mesh_shape.get("model", 1)
    return pod, data, model


def param_bytes_per_device(cfg: ModelConfig, mesh_shape: dict) -> float:
    _, data, model = _shards(mesh_shape)
    return cfg.param_count() * F32 / (data * model)


def _attn_layers(cfg: ModelConfig) -> int:
    per = sum(1 for s in cfg.superblock()
              if s.kind in ("attn", "attn_cross"))
    n = per * cfg.num_superblocks
    if cfg.enc_layers:
        n += cfg.enc_layers
    return n


def _cache_bytes_global(cfg: ModelConfig, seq: int, batch: int) -> float:
    """KV caches + SSM states, global bytes."""
    total = 0.0
    eff = min(seq, cfg.window) if cfg.window else seq
    total += (_attn_layers(cfg) * batch * eff * cfg.num_kv_heads *
              cfg.head_dim * 2 * BF16)
    mamba_layers = sum(1 for s in cfg.superblock()
                       if s.kind == "mamba") * cfg.num_superblocks
    total += (mamba_layers * batch * cfg.ssm_heads * cfg.ssm_headdim *
              cfg.ssm_state * F32)
    cross_layers = sum(1 for s in cfg.superblock()
                       if s.kind in ("cross_attn", "attn_cross")
                       ) * cfg.num_superblocks
    if cross_layers:
        mem_len = (cfg.num_audio_frames if cfg.enc_layers
                   else cfg.num_image_tokens)
        total += (cross_layers * batch * mem_len * cfg.num_kv_heads *
                  cfg.head_dim * 2 * BF16)
    return total


def analytic_bytes(cfg: ModelConfig, kind: str, seq: int, batch: int,
                   mesh_shape: dict, flash_attention: bool = False) -> dict:
    """Per-device HBM bytes for one step; returns the breakdown."""
    pod, data, model = _shards(mesh_shape)
    batch_shards = pod * data
    chips = pod * data * model
    p_dev = param_bytes_per_device(cfg, mesh_shape)

    if kind == "decode":
        cache_dev = _cache_bytes_global(cfg, seq, batch) / chips
        return {"weights": p_dev, "cache": cache_dev,
                "acts": batch * cfg.d_model * BF16 * cfg.num_layers * 4
                / batch_shards,
                "attn_s2": 0.0,
                "total": p_dev + cache_dev}

    tokens_dev = batch * seq / batch_shards
    if kind == "train":
        weights = p_dev * 3          # fwd + remat fwd + bwd weight reads
        optimizer = p_dev * 9        # adam r/w + grads
    else:  # prefill
        weights = p_dev
        optimizer = 0.0
    act_streams = 16
    acts = (cfg.num_layers + cfg.enc_layers) * tokens_dev * cfg.d_model * \
        BF16 * act_streams / model if model else 0
    acts = acts * (3 if kind == "train" else 1)
    # attention score materialization (skipped if a flash kernel is fused)
    attn_s2 = 0.0
    if not flash_attention:
        eff = min(seq, cfg.window) if cfg.window else seq
        h_dev = max(cfg.num_heads / model, 1)
        b_dev = max(batch / batch_shards, 1)
        attn_s2 = _attn_layers(cfg) * b_dev * h_dev * seq * eff * 12.0
        attn_s2 *= (3 if kind == "train" else 1)
    cache_w = _cache_bytes_global(cfg, seq, batch) / chips \
        if kind == "prefill" else 0.0
    total = weights + optimizer + acts + attn_s2 + cache_w
    return {"weights": weights, "optimizer": optimizer, "acts": acts,
            "attn_s2": attn_s2, "cache": cache_w, "total": total}
