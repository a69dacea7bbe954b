"""Mamba2 (SSD, state-space duality) block — port of ``repro.models.mamba``:
the chunked train / prefill scan and the O(1)-state recurrent decode.

Train and prefill split the sequence into chunks of ``CHUNK``; within a
chunk the SSD dual form is an attention-like [Q, Q] masked product, and a
Python loop over the chunks (JAX's ``lax.scan``) carries the float32
[B, H, hd, ds] state. Decode is h <- exp(A dt) h + dt B (x) x per token.
The input projections are split per component (z, x, B, C, dt) as in the
JAX package; its sharding hints (``constrain_weight``) are TPU layout only
and have no counterpart here.

One change of form, not of value: the intra-chunk decay exp(lc_t - lc_i)
is taken of the difference masked to -inf above the diagonal, where JAX
takes it of the raw difference and masks the product. The forward values
are the same (those entries are masked to 0 either way), but above the
diagonal the raw difference grows with the chunk's summed decay; past
~88 it overflows exp to inf (at smoke widths from S = 256), and the
backward's 0 * inf makes JAX's grads NaN there; the port's stay finite.

At bf16, decode keeps the conv outputs and the gated norm's input in
float32 up to the output projection's GEMM. XLA's CPU backend does the same
for the JAX package's fused decode step (it drops convert pairs: excess
precision); rounding them to bf16 op by op put the port's bf16 decode
logits further from JAX's bf16 than JAX's bf16 sits from its own f32
(tests/test_torch_lm.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal_init, pdtype_of, rms_norm

CHUNK = 256


def init_mamba(cfg: ModelConfig, key: torch.Tensor) -> Dict[str, torch.Tensor]:
    pd = pdtype_of(cfg)
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ks = jr.split(key, 6)
    s = d ** -0.5
    dev = key.device

    def zeros(n):
        return torch.zeros((n,), dtype=pd, device=dev)
    return {
        "in_z": normal_init(ks[0], (d, di), s, pd),
        "in_x": normal_init(ks[1], (d, di), s, pd),
        "in_b": normal_init(ks[2], (d, ds), s, pd),
        "in_c": normal_init(ks[3], (d, ds), s, pd),
        "in_dt": normal_init(ks[4], (d, nh), s, pd),
        "conv_x": normal_init(ks[5], (cfg.ssm_conv, di), 0.1, pd),
        "conv_b": normal_init(jr.fold_in(key, 7), (cfg.ssm_conv, ds), 0.1,
                              pd),
        "conv_c": normal_init(jr.fold_in(key, 8), (cfg.ssm_conv, ds), 0.1,
                              pd),
        "conv_bias_x": zeros(di),
        "conv_bias_b": zeros(ds),
        "conv_bias_c": zeros(ds),
        "A_log": zeros(nh),
        "dt_bias": zeros(nh),
        "D": torch.ones((nh,), dtype=pd, device=dev),
        "norm": zeros(di),
        "out_proj": normal_init(jr.fold_in(key, 9), (di, d), di ** -0.5, pd),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. x [B, S, C], w [K, C]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):  # small static K (4): unrolled taps, JAX's order
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return F.silu(out + b)


def _project(p: Dict, x: torch.Tensor):
    """(z, xr, br, cr, dtr): the split input projections; xr/br/cr are the
    pre-conv raw streams."""
    dt_ = x.dtype
    return tuple(x @ p[name].to(dt_)
                 for name in ("in_z", "in_x", "in_b", "in_c", "in_dt"))


def _ssd_chunk_scan(xh: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    h0: torch.Tensor, causal: torch.Tensor):
    """One chunk of the SSD dual form.

    xh [B,Q,H,hd]; bmat/cmat [B,Q,ds]; dt [B,Q,H]; a = A*dt (negative);
    h0 [B,H,hd,ds] float32; causal [1,Q,Q,1] bool, t >= i. Returns
    (y [B,Q,H,hd], h1).
    """
    lc = torch.cumsum(a, dim=1)                    # [B,Q,H] log decay cumsum
    # intra-chunk: M[t,i] = (C_t.B_i) * exp(lc_t - lc_i) * dt_i  (t >= i);
    # the ratio is exactly 0 above the diagonal, so M is too
    cb = torch.einsum("bts,bis->bti", cmat, bmat)  # [B,Q,Q]
    diff = lc[:, :, None, :] - lc[:, None, :, :]   # [B,Q,Q,H]
    ratio = torch.exp(torch.where(causal, diff, float("-inf")))
    m = cb[..., None] * ratio * dt[:, None, :, :]
    y = torch.einsum("btih,bihd->bthd", m.to(xh.dtype), xh)
    # inter-chunk: y += exp(lc_t) * C_t . h0
    p = torch.exp(lc)                              # [B,Q,H]
    y = y + torch.einsum("bts,bhds->bthd", cmat, h0.to(xh.dtype)) * \
        p[..., None].to(xh.dtype)
    # state update: h1 = exp(lc_Q) h0 + sum_i exp(lc_Q - lc_i) dt_i B_i (x) x_i
    pq = torch.exp(lc[:, -1])                      # [B,H]
    coef = torch.exp(lc[:, -1:, :] - lc) * dt      # [B,Q,H]
    h_new = torch.einsum("bqhd,bqs->bhds",
                         xh.float() * coef.float()[..., None], bmat.float())
    h1 = pq[:, :, None, None] * h0 + h_new
    return y, h1


def mamba_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence (train / prefill) forward. x [B, S, D]; S must be a
    multiple of ``min(CHUNK, S)``, as in the JAX package (no padding)."""
    dt_ = x.dtype
    b, s, _ = x.shape
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, xr, br, cr, dtr = _project(p, x)
    xc = _causal_conv(xr, p["conv_x"].to(dt_), p["conv_bias_x"].to(dt_))
    bmat = _causal_conv(br, p["conv_b"].to(dt_), p["conv_bias_b"].to(dt_))
    cmat = _causal_conv(cr, p["conv_c"].to(dt_), p["conv_bias_c"].to(dt_))
    dt = _softplus(dtr.float() + p["dt_bias"].float())    # [B,S,H]
    a_neg = -torch.exp(p["A_log"].float()) * dt            # [B,S,H]
    xh = xc.reshape(b, s, nh, hd)

    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    h = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    ys = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        y, h = _ssd_chunk_scan(xh[:, sl], bmat[:, sl], cmat[:, sl],
                               dt[:, sl], a_neg[:, sl], h, causal)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y, p["norm"]) * F.silu(z)
    out = y @ p["out_proj"].to(dt_)
    if return_state:
        # conv caches hold the last K-1 *pre-conv* rows of each stream
        k1 = cfg.ssm_conv - 1
        return out, {"h": h, "cx": xr[:, -k1:, :], "cb": br[:, -k1:, :],
                     "cc": cr[:, -k1:, :]}
    return out


def mamba_prefill(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """Full-sequence forward returning (y, cache) for subsequent decode."""
    return mamba_apply(cfg, p, x, return_state=True)


# ---------------- decode ----------------

def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    k1 = cfg.ssm_conv - 1
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                          cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "cx": torch.zeros((batch, k1, cfg.d_inner), dtype=dtype,
                          device=device),
        "cb": torch.zeros((batch, k1, cfg.ssm_state), dtype=dtype,
                          device=device),
        "cc": torch.zeros((batch, k1, cfg.ssm_state), dtype=dtype,
                          device=device),
    }


def _conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One causal-conv step: hist [B, K-1, C] + new [B, C] -> (the float32
    output [B, C], the new history in the cache's dtype)."""
    full = torch.cat([hist, new[:, None, :]], dim=1)
    out = (full.float() * w.float()[None]).sum(dim=1) + b.float()
    return F.silu(out), full[:, 1:, :]


def mamba_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step. x [B, 1, D]. Returns (out [B, 1, D], the
    new cache) and leaves ``cache`` as it was."""
    dt_ = x.dtype
    b = x.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    z, xr, br, cr, dtr = (t[:, 0] for t in _project(p, x[:, 0:1]))
    xc, ncx = _conv_step(cache["cx"], xr, p["conv_x"].to(dt_),
                         p["conv_bias_x"].to(dt_))
    bvec, ncb = _conv_step(cache["cb"], br, p["conv_b"].to(dt_),
                           p["conv_bias_b"].to(dt_))
    cvec, ncc = _conv_step(cache["cc"], cr, p["conv_c"].to(dt_),
                           p["conv_bias_c"].to(dt_))
    dt = _softplus(dtr.float() + p["dt_bias"].float())       # [B,H]
    a = torch.exp(-torch.exp(p["A_log"].float()) * dt)       # [B,H]
    xh = xc.reshape(b, nh, hd).float()
    upd = torch.einsum("bhd,bs->bhds", xh * dt[:, :, None],
                       bvec.float())
    h = a[:, :, None, None] * cache["h"] + upd
    y = torch.einsum("bhds,bs->bhd", h, cvec.float())
    y = (y + xh * p["D"].float()[None, :, None])
    y = y.reshape(b, cfg.d_inner)
    y = (rms_norm(y, p["norm"]) * F.silu(z.float())).to(dt_)
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"h": h, "cx": ncx, "cb": ncb, "cc": ncc}
