"""Wrapper of the fused SGNS kernel (``csrc/sgns.cu``).

:func:`sgns_fused` replaces the Pallas kernel
``repro.kernels.sgns.sgns_fused``: for gathered embedding rows it returns
the masked SGNS loss sum and the three row gradients in one pass over the
rows. It takes the unpadded contract (any ``B >= 0``, ``K >= 1``,
``D >= 1``) and is bound by device-memory bytes. A CUDA tensor launches the
kernel, a CPU tensor runs the plain version beside it
(:func:`sgns_fused_plain`), anything else raises. Launches are counted in
``sgns_fused.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.node2vec_step import _check

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from repro_torch.kernels import build
    lib = build.load("sgns")
    if not getattr(lib, "_typed", False):
        lib.sgns_fused_blocks.argtypes = [_I]
        lib.sgns_fused_blocks.restype = _I
        lib.sgns_fused_launch.argtypes = [_P] * 9 + [_I] * 3 + [_P]
        lib.sgns_fused_launch.restype = _I
        lib._typed = True
    return lib


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as max(x, 0) + log1p(exp(-|x|)), i.e. logaddexp(0, x)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def sgns_fused_plain(ci: torch.Tensor, po: torch.Tensor, no: torch.Tensor,
                     valid: torch.Tensor):
    """Plain PyTorch version of the kernel: the closed form of
    ``repro.kernels.sgns.sgns_row_grads`` ("jnp")."""
    x_p = (ci * po).sum(-1)                                  # [B]
    x_n = (no * ci[:, None, :]).sum(-1)                      # [B, K]
    loss = _softplus(-x_p) + _softplus(x_n).sum(-1)
    loss_sum = (loss * valid).sum()
    coef_p = ((_sigmoid(x_p) - 1.0) * valid)[:, None]        # [B, 1]
    coef_n = _sigmoid(x_n) * valid[:, None]                  # [B, K]
    g_po = coef_p * ci
    g_no = coef_n[:, :, None] * ci[:, None, :]
    g_ci = coef_p * po + (coef_n[:, :, None] * no).sum(1)
    return loss_sum, g_ci, g_po, g_no


def sgns_fused(ci: torch.Tensor, po: torch.Tensor, no: torch.Tensor,
               valid: torch.Tensor):
    """Fused SGNS loss and row gradients.

    ci, po [B, D] float32, no [B, K, D] float32, valid [B] float32 (row
    weights, 0 masks a row out). Returns (loss_sum, g_ci [B, D],
    g_po [B, D], g_no [B, K, D]); loss_sum is a 0-d tensor, the masked sum.
    """
    if no.dim() != 3:
        raise ValueError(f"no must be [B, K, D], got {tuple(no.shape)}")
    b, k, d = no.shape
    dev = ci.device
    _check("ci", ci, torch.float32, (b, d), dev)
    _check("po", po, torch.float32, (b, d), dev)
    _check("no", no, torch.float32, (b, k, d), dev)
    _check("valid", valid, torch.float32, (b,), dev)
    if k < 1 or d < 1:
        raise ValueError(f"need K >= 1 and D >= 1, got K={k}, D={d}")
    if dev.type == "cpu":
        return sgns_fused_plain(ci, po, no, valid)
    if dev.type != "cuda":
        raise ValueError(f"sgns_fused runs on cuda or cpu, not {dev}")
    from repro_torch.kernels import build
    g_ci = torch.empty((b, d), dtype=torch.float32, device=dev)
    g_po = torch.empty((b, d), dtype=torch.float32, device=dev)
    g_no = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    if b == 0:
        return torch.zeros((), dtype=torch.float32, device=dev), g_ci, \
            g_po, g_no
    loss = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _lib()
    partial = torch.empty(lib.sgns_fused_blocks(b), dtype=torch.float32,
                          device=dev)
    build.check(lib.sgns_fused_launch(
        ci.data_ptr(), po.data_ptr(), no.data_ptr(), valid.data_ptr(),
        partial.data_ptr(), loss.data_ptr(), g_ci.data_ptr(),
        g_po.data_ptr(), g_no.data_ptr(), b, k, d,
        torch.cuda.current_stream(dev).cuda_stream), "sgns_fused")
    sgns_fused.launches += 1
    return loss[0], g_ci, g_po, g_no


sgns_fused.launches = 0
