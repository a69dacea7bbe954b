"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU by name;
with no card and no explicit device they raise rather than fall back.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is present); anything else
    is taken as given (``"cpu"`` for the tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms on the card for the enclosed ops (scatter-
    adds sort their indices instead of racing float atomics); the CPU's
    scatters are deterministic already."""
    if device.type != "cuda":
        yield
        return
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)
