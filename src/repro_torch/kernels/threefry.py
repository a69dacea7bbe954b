"""Wrapper of the threefry2x32 kernel (``csrc/threefry.cu``).

:func:`threefry2x32` is one launch a call: one threefry2x32-20 evaluation
over an output shape, each operand a tensor read where it lies (broadcast
by stride 0, views as they are), a Python int or a :class:`Count` the
kernel computes from the element's index, and one of three epilogues
(:data:`OUTS`). It replaces no Pallas kernel: it replaces ``jax.random``'s
threefry, which XLA fuses into one loop, and the ~170 eager int64 ops an
evaluation that :func:`repro_torch.random.threefry2x32_plain` launches.
``repro_torch.random._evaluate`` routes CUDA keys here and evaluates CPU
keys with that plain version, whose bits the kernel's equal.

It takes CUDA tensors only, and raises on another device or dtype. Its
launches count in ``threefry2x32.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_DIMS = 8                 # csrc/threefry.cu's kMaxDims
OUTS = ("key", "xor", "uniform")
_INT64, _INT32, _LOW, _HIGH = range(4)     # csrc/threefry.cu's Kind


class Count(NamedTuple):
    """A counter word computed from each element's index: bits 32..63
    (``hi``) or 0..31 of ``base + c``, ``c`` the element's coordinate
    along dim ``dim`` of the output."""
    base: int
    dim: int
    hi: bool = False


def _lib():
    from repro_torch.kernels import build
    lib = build.load("threefry")
    if not getattr(lib, "_typed", False):
        lib.threefry2x32_launch.argtypes = [_P, _P, _I, _P, _P]
        lib.threefry2x32_launch.restype = _I
        lib._typed = True
    return lib


def _operand(name: str, x, shape: tuple, dev: torch.device):
    """(kind, base, per-dim strides or coefs, data pointer or None)."""
    ndim = len(shape)
    if isinstance(x, Count):
        if not 0 <= x.dim < ndim:
            raise ValueError(f"{name} counts along dim {x.dim} of {shape}")
        coefs = [0] * ndim
        coefs[x.dim] = 1
        return _HIGH if x.hi else _LOW, int(x.base), coefs, None
    if isinstance(x, int):
        return _LOW, x & 0xFFFFFFFF, [0] * ndim, None
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, an int or a Count, got "
                        f"{type(x).__name__}")
    dtypes = (torch.int64,) if name[0] == "k" else (torch.int64,
                                                    torch.int32)
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {x.dtype}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    lead = ndim - x.dim()
    if lead < 0 or any(s not in (1, shape[lead + i])
                       for i, s in enumerate(x.shape)):
        raise ValueError(f"{name} of shape {tuple(x.shape)} does not "
                         f"broadcast to {shape}")
    strides = [0] * lead + [st if s != 1 else 0
                            for s, st in zip(x.shape, x.stride())]
    return _INT64 if x.dtype == torch.int64 else _INT32, 0, strides, \
        x.data_ptr()


def _coalesce(shape: tuple, strides: list):
    """The output's dims without those of size 1, each run of dims that
    every operand steps through as one merged: (sizes, per-dim stride
    columns)."""
    sizes, cols = [], []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        col = [s[d] for s in strides]
        if sizes and all(p == c * size for p, c in zip(cols[-1], col)):
            sizes[-1] *= size
            cols[-1] = col
        else:
            sizes.append(size)
            cols.append(col)
    return (sizes, cols) if sizes else ([1], [[0] * len(strides)])


def describe(shape: tuple, operands, dev: torch.device):
    """The kernel's descriptor of one evaluation over ``shape`` and its
    operands (k0, k1, x0, x1): ``desc`` (ndim, the element count, the
    merged dims' sizes, then each operand's kind, base and strides or
    coefs a dim) and the operands' data pointers (None where computed)."""
    if len(shape) > MAX_DIMS:
        raise ValueError(f"at most {MAX_DIMS} dims, got shape {shape}")
    ops = [_operand(name, x, shape, dev)
           for name, x in zip(("k0", "k1", "x0", "x1"), operands)]
    sizes, cols = _coalesce(shape, [op[2] for op in ops])
    desc = [len(sizes), math.prod(shape), *sizes]
    for k, (kind, base, _, _) in enumerate(ops):
        desc += [kind, base, *(col[k] for col in cols)]
    return desc, [op[3] for op in ops]


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0, x1, shape,
                 out: str):
    """threefry2x32-20 of counter words (x0, x1) under key words (k0, k1)
    over ``shape``, in one launch.

    k0, k1: int64 CUDA tensors of uint32 words (their low 32 bits are
    read); x0, x1: int64 or int32 tensors on the same card, Python ints or
    :class:`Count`\\ s. Tensors broadcast to ``shape``. ``out``:
    ``"key"`` -> int64 ``shape + (2,)`` of (o0, o1); ``"xor"`` -> int64
    ``o0 ^ o1``; ``"uniform"`` -> float32
    ``f32((o0 ^ o1) >> 9 | 0x3F800000) - 1``.
    """
    if out not in OUTS:
        raise ValueError(f"out must be one of {OUTS}, got {out!r}")
    if not isinstance(k0, torch.Tensor):
        raise TypeError(f"k0 must be a tensor, got {type(k0).__name__}")
    dev = k0.device
    if dev.type != "cuda":
        raise ValueError(f"threefry2x32 runs on cuda, not {dev} (the CPU "
                         "evaluates random.threefry2x32_plain)")
    shape = tuple(int(s) for s in shape)
    desc, ptrs = describe(shape, (k0, k1, x0, x1), dev)
    res = torch.empty(shape + ((2,) if out == "key" else ()),
                      dtype=torch.float32 if out == "uniform"
                      else torch.int64, device=dev)
    if desc[1] == 0:
        return res
    from repro_torch.kernels import build
    build.check(_lib().threefry2x32_launch(
        (ctypes.c_int64 * len(desc))(*desc), (_P * 4)(*ptrs),
        OUTS.index(out), res.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "threefry2x32")
    threefry2x32.launches += 1
    return res


threefry2x32.launches = 0
