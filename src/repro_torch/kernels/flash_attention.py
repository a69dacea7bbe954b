"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention`` and its padding wrapper
``repro.kernels.ops.flash_attention_op``: causal (optionally sliding-window)
attention over the model layout q [B, S, H, dh], k, v [B, S, KV, dh], with
GQA read in place. It takes the unpadded contract and so follows the
oracle ``repro.kernels.ref.flash_attention_ref``, not the op: for
``causal=False`` the op pads S with zero keys that its kernel then counts
in the softmax. A CUDA tensor launches the kernel, a CPU tensor runs the
plain version beside it (:func:`flash_attention_plain`), anything else
raises. Launches are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
MAX_DH = 256                     # the widest head the kernel's tiles take
_DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = [_P] * 4 + [_I] * 5 + \
            [_F, _I, _I, _I, _P]
        lib.flash_attention_launch.restype = _I
        lib._typed = True
    return lib


def visible(s: int, window: int = 0, causal: bool = True,
            device=None) -> torch.Tensor:
    """[s, s] bool: where query ``i`` may see key ``j`` (``j <= i`` if
    causal, ``j > i - window`` if windowed)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int = 0, causal: bool = True
                          ) -> torch.Tensor:
    """Plain PyTorch version: ``ref.flash_attention_ref`` on the model
    layout — materialized float32 scores, masked to -1e30, softmax, then the
    weighted sum of v — with each KV head repeated for its query heads."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    kk = k.float().repeat_interleave(rep, dim=2)
    vv = v.float().repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * dh ** -0.5
    ok = visible(s, window, causal, q.device)
    probs = torch.softmax(logits.masked_fill_(~ok, NEG_INF), dim=-1)
    del logits
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, dh = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != \
            (b, s, dh):
        raise ValueError(f"k and v must be [B, S, KV, dh] = [{b}, {s}, KV, "
                         f"{dh}], got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} heads are not a multiple of {k.shape[2]} KV "
                         f"heads")
    if dh < 1 or window < 0:
        raise ValueError(f"need dh >= 1 and window >= 0, got dh={dh}, "
                         f"window={window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention forward with an online softmax in float32.

    q [B, S, H, dh], k, v [B, S, KV, dh], contiguous, all float32 or all
    bfloat16; ``window > 0`` keeps keys with ``kpos > qpos - window``.
    Returns o [B, S, H, dh] in q's dtype.
    """
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, window, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    b, s, h, dh = q.shape
    if dh > MAX_DH or b * h > 65535:
        raise ValueError(f"the kernel takes dh <= {MAX_DH} and B * H <= "
                         f"65535, got dh={dh}, B * H={b * h}")
    lib = _lib()
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    from repro_torch.kernels import build
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
        k.shape[2], dh, dh ** -0.5, int(causal), int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream), "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
