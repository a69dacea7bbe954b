"""Learning-rate schedules — port of ``repro.optim.schedules``.

Each is a function of the optimizer's step count (a 0-d integer tensor)
that returns a float32 0-d tensor on the count's device, so an optimizer
step that reads it makes no host-device copy.
"""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda count: torch.tensor(value, dtype=torch.float32,
                                      device=count.device)


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         floor: float = 0.0):
    """MaxText-style warmup -> cosine decay to ``floor``."""

    def fn(count):
        c = count.to(torch.float32)
        warm = peak * (c + 1) / max(warmup_steps, 1)
        progress = torch.clamp((c - warmup_steps) /
                               max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(c < warmup_steps, warm, cos)

    return fn


def inverse_sqrt(peak: float, warmup_steps: int):
    def fn(count):
        c = torch.clamp(count.to(torch.float32), min=1.0)
        return peak * torch.minimum(c / max(warmup_steps, 1),
                                    torch.sqrt(warmup_steps / c))

    return fn
