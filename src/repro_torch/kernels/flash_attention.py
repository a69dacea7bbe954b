"""Wrapper of the flash-attention kernels (``csrc/flash_attention_sm90.cu``
and ``csrc/flash_attention.cu``).

:func:`flash_attention` replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention`` and its padding wrapper
``repro.kernels.ops.flash_attention_op``: causal (optionally sliding-window)
attention over the model layout q [B, S, H, dh], k, v [B, S, KV, dh], with
GQA read in place. It takes the unpadded contract and so follows the
oracle ``repro.kernels.ref.flash_attention_ref``, not the op: for
``causal=False`` the op pads S with zero keys that its kernel then counts
in the softmax. A CUDA tensor launches one of two hand-written kernels,
chosen by :func:`route` from the dtype and dh alone: bfloat16 with dh a
multiple of 16 takes the tensor-core kernel (``"tc"``: wgmma fed by TMA,
the float32 weights entering the P.V product as bf16 hi and lo parts),
everything else the float32 SIMT kernel (``"simt"``: float32 arithmetic
throughout). A CPU
tensor runs the plain version beside them (:func:`flash_attention_plain`),
anything else raises. Launches are counted in ``flash_attention.launches``
and, by route, in ``flash_attention.launches_tc`` and
``flash_attention.launches_simt``.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
MAX_DH = 256                     # the widest head either kernel takes
TC_BLOCK_Q = 128                 # q rows a block of the tensor-core kernel
MAX_GRID = 65535                 # the grid's y extent
_DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (library, C entry point, its argument types after the four pointers)
_ROUTES = {"tc": ("flash_attention_sm90", "flash_attention_sm90_launch",
                  [_I] * 5 + [_F, _I, _I, _P]),
           "simt": ("flash_attention", "flash_attention_launch",
                    [_I] * 5 + [_F, _I, _I, _I, _P])}


def _entry(which: str):
    from repro_torch.kernels import build
    name, fn_name, tail = _ROUTES[which]
    fn = getattr(build.load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + tail
        fn.restype = _I
    return fn


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel a CUDA call with this dtype and head width takes:
    ``"tc"`` (bfloat16 tensor cores) for bfloat16 with dh a multiple of 16,
    else ``"simt"`` (float32 arithmetic on the SIMT cores). Raises for a dh
    neither takes."""
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"flash_attention takes 1 <= dh <= {MAX_DH}, got "
                         f"dh={dh}")
    return "tc" if dtype == torch.bfloat16 and dh % 16 == 0 else "simt"


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
    if window < 0:
        raise ValueError(f"need window >= 0, got window={window}")
    route(q.dtype, dh)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention forward with an online softmax in float32.

    q [B, S, H, dh], k, v [B, S, KV, dh], contiguous, all float32 or all
    bfloat16, 1 <= dh <= 256; ``window > 0`` keeps keys with
    ``kpos > qpos - window``. Returns o [B, S, H, dh] in q's dtype.
    """
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, window, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return launch(route(q.dtype, q.shape[3]), q, k, v, window, causal)


def launch(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int = 0, causal: bool = True) -> torch.Tensor:
    """Launch the kernel of route ``which`` on checked CUDA tensors and
    count it. :func:`flash_attention` calls it with :func:`route`'s choice;
    called directly, ``"simt"`` also takes bfloat16 at any dh (the
    yardstick of the bf16 route)."""
    b, s, h, dh = q.shape
    if which == "tc":
        if q.dtype != torch.bfloat16 or dh % 16:
            raise ValueError(f"the tensor-core kernel takes bfloat16 with dh "
                             f"a multiple of 16, got {q.dtype}, dh={dh}")
        if -(-s // TC_BLOCK_Q) > MAX_GRID:
            raise ValueError(f"the tensor-core kernel takes S <= "
                             f"{TC_BLOCK_Q * MAX_GRID}, got S={s}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the tensor-core kernel reads q, k and v with "
                             "TMA, which needs 16-byte aligned addresses")
        scale = dh ** -0.5 * math.log2(math.e)    # exp2 of the scaled score
    else:
        if b * h > MAX_GRID:
            raise ValueError(f"the SIMT kernel takes B * H <= {MAX_GRID}, "
                             f"got B * H={b * h}")
        scale = dh ** -0.5
    fn = _entry(which)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    from repro_torch.kernels import build
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], dh, scale, int(causal), int(window)]
    if which == "simt":
        args.append(int(q.dtype == torch.bfloat16))
    build.check(fn(*args, torch.cuda.current_stream(q.device).cuda_stream),
                f"flash_attention ({which})")
    flash_attention.launches += 1
    if which == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_simt += 1
    return o


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0
