"""Architecture registry — the port's copy of ``repro.configs``.

Config files are named with the exact architecture ids (which contain dots
and dashes, e.g. ``jamba-v0.1-52b.py``), so they are loaded by path rather
than as package modules.

    get_config("yi-6b")           -> full ModelConfig
    smoke_config("yi-6b")         -> reduced same-family config (CPU tests)

``input_specs`` (shape stand-ins for the JAX dry run) is not carried over.
"""
from __future__ import annotations

import importlib.util
import os
from typing import List

from repro_torch.configs.base import SHAPES, smoke_reduce
from repro_torch.models.config import ModelConfig

_DIR = os.path.dirname(__file__)
_EXCLUDE = {"__init__.py", "base.py"}

__all__ = ["SHAPES", "get_config", "list_archs", "smoke_config"]


def list_archs() -> List[str]:
    return [fn[:-3] for fn in sorted(os.listdir(_DIR))
            if fn.endswith(".py") and fn not in _EXCLUDE]


def _load(arch: str):
    path = os.path.join(_DIR, arch + ".py")
    if not os.path.exists(path):
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    spec = importlib.util.spec_from_file_location(
        "repro_torch_config_" + arch.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return smoke_reduce(get_config(arch))
