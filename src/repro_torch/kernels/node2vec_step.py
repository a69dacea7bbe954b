"""Wrappers of the two node2vec walk kernels (``csrc/node2vec_step.cu``).

* :func:`node2vec_step` replaces the Pallas kernel
  ``repro.kernels.node2vec_step.node2vec_step``: one exact second-order
  draw per walker (``Sampler.exact`` on the fused backend).
* :func:`node2vec_walk` replaces ``repro.kernels.node2vec_step.
  node2vec_walk``: steps 1..L-1 of an exact walk on the FN-Base layout in
  one launch, each walker's prev row kept on chip between steps.

Both take the unpadded contract (no 128-lane or block-multiple padding) and
are bound by device-memory bytes. A CUDA tensor launches the kernel, a CPU
tensor runs the plain version beside it (``*_plain``), anything else raises.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.engine.sampler import exact_slots

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from repro_torch.kernels import build
    lib = build.load("node2vec_step")
    if not getattr(lib, "_typed", False):
        lib.node2vec_scratch_floats.argtypes = [_I, _I]
        lib.node2vec_scratch_floats.restype = _I
        lib.node2vec_step_launch.argtypes = [_P] * 6 + [_I] * 3 + \
            [_F, _F, _P, _P]
        lib.node2vec_step_launch.restype = _I
        lib.node2vec_walk_launch.argtypes = [_P] * 7 + [_I] * 3 + \
            [_F, _F, _P, _P]
        lib.node2vec_walk_launch.restype = _I
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _inv(x: float) -> float:
    """1/x rounded once to float32, as JAX rounds its weak scalar."""
    return float(np.float32(1.0 / x))


def _launch_args(device: torch.device, d: int, walkers: int,
                 with_prev: int):
    """(scratch tensor or None, its pointer, the stream) for one launch."""
    per = _lib().node2vec_scratch_floats(d, with_prev)
    scratch = torch.empty(walkers * per, dtype=torch.float32,
                          device=device) if per else None
    ptr = scratch.data_ptr() if per else None
    return scratch, ptr, torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------ step kernel --

def node2vec_step_plain(cand_ids, cand_w, u, prev_ids, rand, p: float,
                        q: float) -> torch.Tensor:
    """Plain PyTorch version of the step kernel (the sampler's contract)."""
    return exact_slots(cand_ids, cand_w, u, prev_ids, rand, p, q)


def node2vec_step(cand_ids: torch.Tensor, cand_w: torch.Tensor,
                  u: torch.Tensor, prev_ids: torch.Tensor,
                  rand: torch.Tensor, p: float, q: float) -> torch.Tensor:
    """Exact second-order draw per walker.

    cand_ids [W, D] int32 (PAD_ID padded, sorted), cand_w [W, D] float32,
    u [W] int32, prev_ids [W, DP] int32 (sorted N(u)), rand [W] float32.
    Returns slot [W] int32.
    """
    w, d = cand_ids.shape
    dp = prev_ids.shape[1]
    dev = cand_ids.device
    _check("cand_ids", cand_ids, torch.int32, (w, d), dev)
    _check("cand_w", cand_w, torch.float32, (w, d), dev)
    _check("u", u, torch.int32, (w,), dev)
    _check("prev_ids", prev_ids, torch.int32, (w, dp), dev)
    _check("rand", rand, torch.float32, (w,), dev)
    if d < 1 or dp < 1:
        raise ValueError(f"row widths must be >= 1, got D={d}, DP={dp}")
    if dev.type == "cpu":
        return node2vec_step_plain(cand_ids, cand_w, u, prev_ids, rand, p, q)
    if dev.type != "cuda":
        raise ValueError(f"node2vec_step runs on cuda or cpu, not {dev}")
    from repro_torch.kernels import build
    slot = torch.empty(w, dtype=torch.int32, device=dev)
    if w == 0:
        return slot
    scratch, sptr, stream = _launch_args(dev, d, w, 0)
    build.check(_lib().node2vec_step_launch(
        cand_ids.data_ptr(), cand_w.data_ptr(), u.data_ptr(),
        prev_ids.data_ptr(), rand.data_ptr(), slot.data_ptr(), w, d, dp,
        _inv(p), _inv(q), sptr, stream), "node2vec_step")
    node2vec_step.launches += 1
    return slot


node2vec_step.launches = 0


# ------------------------------------------------------------ walk kernel --

def node2vec_walk_plain(adj, wgt, deg, u0, v1, rand, p: float,
                        q: float) -> torch.Tensor:
    """Plain PyTorch version of the walk kernel: the same draws, one
    superstep at a time."""
    u, v = u0, v1
    prev = adj[u0.long()]
    cols = []
    for s in range(rand.shape[1]):
        cand, w = adj[v.long()], wgt[v.long()]
        slot = exact_slots(cand, w, u, prev, rand[:, s].contiguous(), p, q)
        nxt = torch.gather(cand, 1, slot.long()[:, None])[:, 0]
        nxt = torch.where(deg[v.long()] > 0, nxt, v)   # dead end: stay
        u, v, prev = v, nxt, cand
        cols.append(nxt)
    if not cols:
        return torch.empty((u0.shape[0], 0), dtype=torch.int32,
                           device=adj.device)
    return torch.stack(cols, dim=1)


def node2vec_walk(adj: torch.Tensor, wgt: torch.Tensor, deg: torch.Tensor,
                  u0: torch.Tensor, v1: torch.Tensor, rand: torch.Tensor,
                  p: float, q: float) -> torch.Tensor:
    """Steps 1..L-1 of an exact walk on the FN-Base layout.

    adj [n, D] int32, wgt [n, D] float32, deg [n] int32, u0/v1 [W] int32
    (start vertex, step-0 result), rand [W, L-1] float32 uniforms.
    Returns [W, L-1] int32 sampled vertices.
    """
    n, d = adj.shape
    w, steps = rand.shape
    dev = adj.device
    _check("adj", adj, torch.int32, (n, d), dev)
    _check("wgt", wgt, torch.float32, (n, d), dev)
    _check("deg", deg, torch.int32, (n,), dev)
    _check("u0", u0, torch.int32, (w,), dev)
    _check("v1", v1, torch.int32, (w,), dev)
    _check("rand", rand, torch.float32, (w, steps), dev)
    if d < 1:
        raise ValueError(f"row width must be >= 1, got D={d}")
    if dev.type == "cpu":
        return node2vec_walk_plain(adj, wgt, deg, u0, v1, rand, p, q)
    if dev.type != "cuda":
        raise ValueError(f"node2vec_walk runs on cuda or cpu, not {dev}")
    from repro_torch.kernels import build
    out = torch.empty((w, steps), dtype=torch.int32, device=dev)
    if w == 0 or steps == 0:
        return out
    scratch, sptr, stream = _launch_args(dev, d, w, 1)
    build.check(_lib().node2vec_walk_launch(
        adj.data_ptr(), wgt.data_ptr(), deg.data_ptr(), u0.data_ptr(),
        v1.data_ptr(), rand.data_ptr(), out.data_ptr(), w, d, steps,
        _inv(p), _inv(q), sptr, stream), "node2vec_walk")
    node2vec_walk.launches += 1
    return out


node2vec_walk.launches = 0
