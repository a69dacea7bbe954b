"""Gradient utilities for training — port of ``repro.optim.grad_utils``.

* ``value_and_grad``: a loss and the grads of every leaf of a params tree
  (dicts of tensors, nested freely), by autograd;
* global-norm clipping;
* gradient accumulation (microbatching);
* int8 error-feedback gradient compression: gradients are quantized to
  int8 with a per-tensor scale before the data-parallel reduction (4x
  fewer collective bytes) and the quantization residual is fed into the
  next step's gradient. Where JAX names a mesh axis, the port takes a
  ``torch.distributed`` process group.

Leaves are visited in sorted key order, as ``jax.tree.leaves`` visits
dicts, so sums over leaves run in the JAX package's order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import _map


def _leaves(tree: Dict):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def value_and_grad(loss_fn: Callable, params: Dict, *args
                   ) -> Tuple[torch.Tensor, Dict]:
    """``jax.value_and_grad(loss_fn)(params, *args)``: the loss (detached)
    and a tree of grads shaped like ``params`` (zeros for a leaf the loss
    does not reach). ``params`` is not changed."""
    leaves = _map(lambda p: p.detach().requires_grad_(True), params)
    flat = list(_leaves(leaves))
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)}
    return loss.detach(), _map(lambda p: by_id[id(p)], leaves)


def global_norm(tree: Dict) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in _leaves(tree)))


def clip_by_global_norm(grads: Dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return _map(lambda g: g * scale, grads), norm


def accumulate_gradients(loss_fn: Callable, params: Dict, batch: Dict,
                         num_microbatches: int):
    """Split ``batch`` (a dict of tensors, on its leading axis) into
    ``num_microbatches`` microbatches and sum their losses and grads in
    order; returns their means. Cuts activation memory by
    ``num_microbatches``."""
    if num_microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)
    micro = {k: v.reshape((num_microbatches, v.shape[0] // num_microbatches)
                          + tuple(v.shape[1:])) for k, v in batch.items()}
    loss = torch.zeros((), dtype=torch.float32,
                       device=next(_leaves(params)).device)
    grads = _map(torch.zeros_like, params)
    for i in range(num_microbatches):
        mb_loss, mb_grads = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in micro.items()})
        loss = loss + mb_loss
        grads = _map(torch.add, grads, mb_grads)
    inv = 1.0 / num_microbatches
    return loss * inv, _map(lambda g: g * inv, grads)


# ---------------- int8 error-feedback compression ----------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params: Dict) -> Dict:
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compressed_psum(grads: Dict, residuals: Dict, group=None
                    ) -> Tuple[Dict, Dict]:
    """Quantize (grad + residual) to int8, all-reduce the int8 payload as
    int32 (SUM) with the scale (MAX) over ``group``, dequantize, divide by
    the group's size, and return the new residuals (``g32 - q * scale``
    at the reduced scale, as JAX's).

    With ``group=None`` (one replica) nothing is reduced, but the
    quantization round trip and its error feedback still happen, so the
    numbers are those of the distributed path with one replica.
    """

    def one(g: torch.Tensor, r: torch.Tensor):
        g32 = g.float() + r
        q, scale = quantize_int8(g32)
        if group is not None:
            qsum = q.to(torch.int32)
            dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
            scale = scale.reshape(1).clone()
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            scale = scale[0]
            deq = qsum.to(torch.float32) * scale
            deq = deq / float(dist.get_world_size(group))
        else:
            deq = dequantize_int8(q, scale)
        new_r = g32 - dequantize_int8(q, scale)
        return deq.to(g.dtype), new_r

    pairs = _map(one, grads, residuals)
    return _map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs)
