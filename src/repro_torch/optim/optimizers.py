"""Optimizers over dicts of tensors — port of ``repro.optim.optimizers``.

The same functional (init, update) style as the JAX package, so optimizer
state can be carried across from it and compared::

    opt = adam(lr=0.025)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, grads, updates and moments are dicts of tensors (the JAX
package's pytrees of one level). Nothing is updated in place: every call
returns new tensors, as JAX does, so a state handed in is never changed.
The step count is a 0-d int32 tensor on the parameters' device, and
scalar hyper-parameters stay Python floats, so a step makes no host-device
copy. ``adam_rows`` (lazy row-Adam) belongs to the sharded trainer and is
not ported yet (ROADMAP.md Queue 1 item 9).
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


def _count(params: dict) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _map(fn, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


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
                          {k: p.dim() >= 2 for k, p in params.items()})
            updates = _map(
                lambda u, p, m: u - step_lr * weight_decay * p * float(m),
                updates, params, decay_mask)
        return updates, AdamState(count, mu, nu)

    key = ("adam", lr, b1, b2, eps, weight_decay) \
        if not callable(lr) and mask is None else None
    return Optimizer(init, update, key)


def apply_updates(params: dict, updates: dict) -> dict:
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)
