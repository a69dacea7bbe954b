"""Wrappers of the node2vec walk kernels (``csrc/node2vec_step.cu``).

* :func:`node2vec_step` replaces the Pallas kernel
  ``repro.kernels.node2vec_step.node2vec_step``: one exact second-order
  draw per walker over given candidate and prev rows (``Sampler.exact`` on
  the fused backend). It reads only the rows' live lanes, up to the first
  ``PAD_ID``, which the kernel finds.
* :func:`node2vec_step_layout` is the same draw reading v's and u's rows in
  place from a :class:`~repro_torch.core.graph.PaddedGraph` (the fused walk
  engine's step): no ``[W, hot_cap]`` rows are built. It returns the slot
  and the next vertex. Its launches count in ``node2vec_step.launches``.
* :func:`node2vec_walk` replaces ``repro.kernels.node2vec_step.
  node2vec_walk``: steps 1..L-1 of an exact walk on the FN-Base layout in
  one launch, each walker's prev row kept on chip between steps.
* :func:`node2vec_step_padded` is the step kernel's first design (every
  lane of the padded rows scanned, membership searched in device memory),
  on no path: ``chip_smoke.py`` times it beside the live-lane kernel.

All take the unpadded contract (no 128-lane or block-multiple padding) and
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
        lib.node2vec_live_scratch_floats.argtypes = [_I, _I]
        lib.node2vec_live_scratch_floats.restype = _I
        for name in ("node2vec_step_padded_launch",
                     "node2vec_step_live_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 6 + [_I] * 3 + [_F, _F, _P, _P]
            fn.restype = _I
        lib.node2vec_step_layout_launch.argtypes = \
            [_P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _F,
             _F, _P, _P]
        lib.node2vec_step_layout_launch.restype = _I
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


def _launch_args(device: torch.device, walkers: int, per: int):
    """(scratch tensor or None, its pointer, the stream) for one launch
    needing ``per`` floats of global scratch a walker."""
    scratch = torch.empty(walkers * per, dtype=torch.float32,
                          device=device) if per else None
    ptr = scratch.data_ptr() if per else None
    return scratch, ptr, torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------- step kernels --

def node2vec_step_plain(cand_ids, cand_w, u, prev_ids, rand, p: float,
                        q: float) -> torch.Tensor:
    """Plain PyTorch version of the step kernel (the sampler's contract)."""
    return exact_slots(cand_ids, cand_w, u, prev_ids, rand, p, q)


def _step_rows(entry: str, counter, cand_ids, cand_w, u, prev_ids, rand,
               p: float, q: float) -> torch.Tensor:
    """A row-contract step kernel (``entry``: "live" or "padded"): the
    checks, the plain version on the CPU, else one launch counted in
    ``counter.launches``."""
    from repro_torch.kernels import build
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
    slot = torch.empty(w, dtype=torch.int32, device=dev)
    if w == 0:
        return slot
    lib = _lib()
    per = lib.node2vec_scratch_floats(d, 0) if entry == "padded" else \
        lib.node2vec_live_scratch_floats(d, dp)
    scratch, sptr, stream = _launch_args(dev, w, per)
    build.check(getattr(lib, f"node2vec_step_{entry}_launch")(
        cand_ids.data_ptr(), cand_w.data_ptr(), u.data_ptr(),
        prev_ids.data_ptr(), rand.data_ptr(), slot.data_ptr(), w, d, dp,
        _inv(p), _inv(q), sptr, stream), f"node2vec_step ({entry})")
    counter.launches += 1
    return slot


def node2vec_step(cand_ids: torch.Tensor, cand_w: torch.Tensor,
                  u: torch.Tensor, prev_ids: torch.Tensor,
                  rand: torch.Tensor, p: float, q: float) -> torch.Tensor:
    """Exact second-order draw per walker.

    cand_ids [W, D] int32 (sorted, PAD_ID padded), cand_w [W, D] float32,
    u [W] int32, prev_ids [W, DP] int32 (sorted N(u), PAD_ID padded),
    rand [W] float32. Returns slot [W] int32.
    """
    return _step_rows("live", node2vec_step, cand_ids, cand_w, u, prev_ids,
                      rand, p, q)


node2vec_step.launches = 0


def node2vec_step_padded(cand_ids: torch.Tensor, cand_w: torch.Tensor,
                         u: torch.Tensor, prev_ids: torch.Tensor,
                         rand: torch.Tensor, p: float, q: float
                         ) -> torch.Tensor:
    """:func:`node2vec_step` by the step kernel's first design, which scans
    every lane of the padded rows (the live-lane kernel's yardstick)."""
    return _step_rows("padded", node2vec_step_padded, cand_ids, cand_w, u,
                      prev_ids, rand, p, q)


node2vec_step_padded.launches = 0


def node2vec_step_layout_plain(pg, u: torch.Tensor, v: torch.Tensor,
                               rand: torch.Tensor, p: float, q: float):
    """Plain PyTorch version of the layout entry: the engine's full-width
    rows (``unified_row``), then :func:`exact_slots`, then the gather."""
    from repro_torch.core.walk import unified_row
    cand, w, _ = unified_row(pg, v, ("adj", "wgt"))
    prev, _ = unified_row(pg, u, ("adj",))
    slot = exact_slots(cand, w, u, prev, rand, p, q)
    nxt = torch.gather(cand, 1, slot.long()[:, None])[:, 0]
    return slot, torch.where(pg.deg[v] > 0, nxt, v)


def node2vec_step_layout(pg, u: torch.Tensor, v: torch.Tensor,
                         rand: torch.Tensor, p: float, q: float):
    """Exact second-order draw per walker, v's and u's rows read in place
    from the padded layout ``pg`` (cold rows of width ``cap``, the hot
    cache at ``hot_cap``).

    u, v [W] int32 (previous and current vertex), rand [W] float32. Returns
    (slot [W] int32, next vertex [W] int32): the same as drawing on the
    ``hot_cap``-wide rows of ``unified_row`` and gathering, a dead end
    (``deg[v] == 0``) staying at v.
    """
    w = v.shape[0]
    dev = pg.device
    _check("u", u, torch.int32, (w,), dev)
    _check("v", v, torch.int32, (w,), dev)
    _check("rand", rand, torch.float32, (w,), dev)
    if dev.type == "cpu":
        return node2vec_step_layout_plain(pg, u, v, rand, p, q)
    if dev.type != "cuda":
        raise ValueError(f"node2vec_step runs on cuda or cpu, not {dev}")
    from repro_torch.kernels import build
    out = torch.empty((2, w), dtype=torch.int32, device=dev)
    if w == 0:
        return out[0], out[1]
    lib = _lib()
    scratch, sptr, stream = _launch_args(
        dev, w, lib.node2vec_live_scratch_floats(pg.hot_cap, pg.hot_cap))
    build.check(lib.node2vec_step_layout_launch(
        pg.adj.data_ptr(), pg.wgt.data_ptr(), pg.cap, pg.hot_adj.data_ptr(),
        pg.hot_wgt.data_ptr(), pg.hot_cap, pg.hot_pos.data_ptr(),
        pg.deg.data_ptr(), pg.n, u.data_ptr(), v.data_ptr(), rand.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), w, _inv(p), _inv(q), sptr,
        stream), "node2vec_step (layout)")
    node2vec_step.launches += 1
    return out[0], out[1]


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
    scratch, sptr, stream = _launch_args(
        dev, w, _lib().node2vec_scratch_floats(d, 1))
    build.check(_lib().node2vec_walk_launch(
        adj.data_ptr(), wgt.data_ptr(), deg.data_ptr(), u0.data_ptr(),
        v1.data_ptr(), rand.data_ptr(), out.data_ptr(), w, d, steps,
        _inv(p), _inv(q), sptr, stream), "node2vec_walk")
    node2vec_walk.launches += 1
    return out


node2vec_walk.launches = 0
