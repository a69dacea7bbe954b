"""Wrappers of the fused SGNS kernel (``csrc/sgns.cu``).

* :func:`sgns_fused` replaces the Pallas kernel
  ``repro.kernels.sgns.sgns_fused``: for gathered embedding rows it returns
  the masked SGNS loss sum and the three row gradients in one pass over the
  rows.
* :func:`sgns_fused_tables` is the same kernel body reading the rows in
  place from the ``[V, D]`` tables at int32 indices, with every output
  divided by a device scalar ``denom``: the same bits as gathering, calling
  :func:`sgns_fused` and dividing, without the gather copies and the
  division passes (``core.skipgram.sgns_grads``' fused backend). Its
  launches count in ``sgns_fused.launches``.

Both take the unpadded contract (any ``B >= 0``, ``K >= 1``, ``D >= 1``)
and are bound by device-memory bytes. A CUDA tensor launches the kernel, a
CPU tensor runs the plain version beside it (``*_plain``), anything else
raises. A call makes two device allocations: one for the grads and the
per-block loss partials, and one for the loss alone, so that a caller who
keeps the loss (a trainer's per-step history) does not keep the grads.
The completion counter that lets the last block sum the loss is allocated
once per (device, stream), at the first launch on that stream, so
launches on different streams may overlap; a CUDA graph that captures a
launch needs one launch on its capture stream first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.node2vec_step import _check

_P = ctypes.c_void_p
_I = ctypes.c_int


_FN: dict = {}          # the typed C entry points, looked up once
_COUNTERS: dict = {}    # the completion counter of each (device, stream)


def _fn(name: str):
    if not _FN:
        from repro_torch.kernels import build
        lib = build.load("sgns")
        for entry, args in (("blocks", [_I]),
                            ("launch", [_P] * 10 + [_I] * 3 + [_P]),
                            ("tables_launch", [_P] * 13 + [_I] * 3 + [_P])):
            fn = getattr(lib, f"sgns_fused_{entry}")
            fn.argtypes, fn.restype = args, _I
            _FN[entry] = fn
    return _FN[name]


def _counter(dev: torch.device, stream: int) -> int:
    """The pointer of the completion counter of ``stream`` on ``dev``: 0
    between launches (each launch leaves it so)."""
    key = (dev.index, stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("sgns_fused: launch once on the capture "
                               "stream before capturing a CUDA graph")
        counter = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                               device=dev)
    return counter.data_ptr()


def _outputs(b: int, k: int, d: int, dev: torch.device):
    """(loss 0-d, g_ci, g_po, g_no, the partials' pointer, the counter's
    pointer, the stream): the grads and the partials share one allocation,
    the loss has its own."""
    blocks = _fn("blocks")(b)
    buf = torch.empty(b * d * (2 + k) + blocks, dtype=torch.float32,
                      device=dev)
    bd = b * d
    end = bd * (2 + k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (torch.empty((), dtype=torch.float32, device=dev),
            buf[:bd].view(b, d), buf[bd:2 * bd].view(b, d),
            buf[2 * bd:end].view(b, k, d), buf.data_ptr() + 4 * end,
            _counter(dev, stream), stream)


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
    if b == 0:
        return _empty(k, d, dev)
    from repro_torch.kernels import build
    loss, g_ci, g_po, g_no, partial, counter, stream = _outputs(b, k, d, dev)
    build.check(_fn("launch")(
        ci.data_ptr(), po.data_ptr(), no.data_ptr(), valid.data_ptr(),
        partial, counter, loss.data_ptr(), g_ci.data_ptr(), g_po.data_ptr(),
        g_no.data_ptr(), b, k, d, stream), "sgns_fused")
    sgns_fused.launches += 1
    return loss, g_ci, g_po, g_no


sgns_fused.launches = 0


def _empty(k: int, d: int, dev: torch.device):
    return (torch.zeros((), dtype=torch.float32, device=dev),
            torch.empty((0, d), dtype=torch.float32, device=dev),
            torch.empty((0, d), dtype=torch.float32, device=dev),
            torch.empty((0, k, d), dtype=torch.float32, device=dev))


def sgns_fused_tables_plain(emb_in, emb_out, center, pos, negs, valid,
                            denom):
    """Plain PyTorch version of the table entry: the gathers, then
    :func:`sgns_fused_plain`, then each output divided by ``denom``."""
    out = sgns_fused_plain(emb_in[center.long()], emb_out[pos.long()],
                           emb_out[negs.long()], valid)
    return tuple(t / denom for t in out)


def sgns_fused_tables(emb_in: torch.Tensor, emb_out: torch.Tensor,
                      center: torch.Tensor, pos: torch.Tensor,
                      negs: torch.Tensor, valid: torch.Tensor,
                      denom: torch.Tensor):
    """:func:`sgns_fused` on rows read in place from the tables, every
    output divided by ``denom``.

    emb_in, emb_out [V, D] float32; center, pos [B] int32; negs [B, K]
    int32; valid [B] float32; denom a 0-d or [1] float32 tensor on the same
    device (the masked mean's divisor, left on the device so nothing waits
    for it). Returns (loss_sum / denom, g_ci / denom [B, D],
    g_po / denom [B, D], g_no / denom [B, K, D]).
    """
    if negs.dim() != 2 or emb_in.dim() != 2:
        raise ValueError(f"negs must be [B, K] and the tables [V, D], got "
                         f"{tuple(negs.shape)} and {tuple(emb_in.shape)}")
    b, k = negs.shape
    v, d = emb_in.shape
    dev = emb_in.device
    _check("emb_out", emb_out, torch.float32, (v, d), dev)
    _check("emb_in", emb_in, torch.float32, (v, d), dev)
    _check("center", center, torch.int32, (b,), dev)
    _check("pos", pos, torch.int32, (b,), dev)
    _check("negs", negs, torch.int32, (b, k), dev)
    _check("valid", valid, torch.float32, (b,), dev)
    if denom.dtype != torch.float32 or denom.numel() != 1 or \
            denom.device != dev:
        raise ValueError("denom must be one float32 on the tables' device")
    if k < 1 or d < 1:
        raise ValueError(f"need K >= 1 and D >= 1, got K={k}, D={d}")
    if dev.type == "cpu":
        return sgns_fused_tables_plain(emb_in, emb_out, center, pos, negs,
                                       valid, denom)
    if dev.type != "cuda":
        raise ValueError(f"sgns_fused runs on cuda or cpu, not {dev}")
    if b == 0:
        return _empty(k, d, dev)
    from repro_torch.kernels import build
    loss, g_ci, g_po, g_no, partial, counter, stream = _outputs(b, k, d, dev)
    build.check(_fn("tables_launch")(
        emb_in.data_ptr(), emb_out.data_ptr(), center.data_ptr(),
        pos.data_ptr(), negs.data_ptr(), valid.data_ptr(), denom.data_ptr(),
        partial, counter, loss.data_ptr(), g_ci.data_ptr(), g_po.data_ptr(),
        g_no.data_ptr(), b, k, d, stream), "sgns_fused")
    sgns_fused.launches += 1
    return loss, g_ci, g_po, g_no
