"""Optimizers over dicts of tensors — port of ``repro.optim.optimizers``.

The same functional (init, update) style as the JAX package, so optimizer
state can be carried across from it and compared::

    opt = adam(lr=0.025)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, grads, updates and moments are dicts of tensors, nested
freely (the JAX package's pytrees of dicts: one level for SGNS tables,
the LM's params tree). Nothing is updated in place: every call
returns new tensors, as JAX does, so a state handed in is never changed.
The step count is a 0-d int32 tensor on the parameters' device, and
scalar hyper-parameters stay Python floats, so a step makes no host-device
copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

Schedule = Callable[[torch.Tensor], Any]
ScalarOrSchedule = Union[float, Schedule]


@dataclasses.dataclass(frozen=True, eq=False)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)
    # Config identity: two factory calls with the same scalar
    # hyper-parameters build the same optimizer and compare equal. ``None``
    # (a callable schedule or a custom mask) falls back to object identity.
    key: Optional[tuple] = None

    def __eq__(self, other):
        if (self.key is not None and isinstance(other, Optimizer)
                and other.key is not None):
            return self.key == other.key
        return self is other

    def __hash__(self):
        return hash(self.key) if self.key is not None else id(self)


def _lr_at(lr: ScalarOrSchedule, count: torch.Tensor):
    return lr(count) if callable(lr) else float(np.float32(lr))


def _first_leaf(tree: dict):
    for v in tree.values():
        leaf = _first_leaf(v) if isinstance(v, dict) else v
        if leaf is not None:
            return leaf
    return None


def _count(params: dict) -> torch.Tensor:
    leaf = _first_leaf(params)
    dev = leaf.device if leaf is not None else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _map(fn, *trees: dict) -> dict:
    """``fn`` over the leaves of dicts of one structure (``jax.tree.map``)."""
    return {k: _map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


class SgdState(NamedTuple):
    count: torch.Tensor
    momentum: Any


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mom = _map(torch.zeros_like, params) if momentum else None
        return SgdState(_count(params), mom)

    def update(grads, state, params=None):
        step_lr = _lr_at(lr, state.count)
        if momentum:
            mom = _map(lambda m, g: momentum * m + g, state.momentum, grads)
            updates = _map(lambda m: -step_lr * m, mom)
        else:
            mom = None
            updates = _map(lambda g: -step_lr * g, grads)
        return updates, SgdState(state.count + 1, mom)

    key = ("sgd", lr, momentum) if not callable(lr) else None
    return Optimizer(init, update, key)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         mask: Optional[Callable[[Any], Any]] = None) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when ``weight_decay > 0``).

    ``mask(params)`` -> dict of bools selecting which tensors get decay
    (default: every tensor with ndim >= 2). Dense: every row of every
    table moves every step, as in the JAX package.
    """

    def init(params):
        return AdamState(_count(params), _map(torch.zeros_like, params),
                         _map(torch.zeros_like, params))

    def update(grads, state, params=None):
        count = state.count + 1
        step_lr = _lr_at(lr, state.count)
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * (g * g), state.nu, grads)
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(np.float32(b1).item(), c)
        bc2 = 1 - torch.pow(np.float32(b2).item(), c)

        def upd(m, v):
            return -step_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

        updates = _map(upd, mu, nu)
        if weight_decay and params is not None:
            decay_mask = (mask(params) if mask is not None else
                          _map(lambda p: p.dim() >= 2, params))
            updates = _map(
                lambda u, p, m: u - step_lr * weight_decay * p * float(m),
                updates, params, decay_mask)
        return updates, AdamState(count, mu, nu)

    key = ("adam", lr, b1, b2, eps, weight_decay) \
        if not callable(lr) and mask is None else None
    return Optimizer(init, update, key)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def adam_rows(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> Optimizer:
    """Row-sparse ("lazy") Adam for embedding tables.

    Moments live per table row and only the rows gathered for the current
    batch move; untouched rows keep their moments frozen. ``init(params)``
    matches :func:`adam`. ``update(g_rows, (mu_rows, nu_rows), count)``
    works on gathered rows: ``count`` is the already-incremented step, and
    it returns ``(row_updates, new_mu_rows, new_nu_rows)`` for the caller
    to write back (the caller owns which rows).
    """

    def init(params):
        return AdamState(_count(params), _map(torch.zeros_like, params),
                         _map(torch.zeros_like, params))

    def update(g_rows, rows_state, count):
        mu_rows, nu_rows = rows_state
        new_mu = b1 * mu_rows + (1 - b1) * g_rows
        new_nu = b2 * nu_rows + (1 - b2) * (g_rows * g_rows)
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(np.float32(b1).item(), c)
        bc2 = 1 - torch.pow(np.float32(b2).item(), c)
        step_lr = _lr_at(lr, count - 1)
        upd = -step_lr * (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + eps)
        return upd, new_mu, new_nu

    key = ("adam_rows", lr, b1, b2, eps) if not callable(lr) else None
    return Optimizer(init, update, key)


def apply_updates(params: dict, updates: dict) -> dict:
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)
