"""Architecture registry — the port's copy of ``repro.configs``.

Config files are named with the exact architecture ids (which contain dots
and dashes, e.g. ``jamba-v0.1-52b.py``), so they are loaded by path rather
than as package modules.

    get_config("yi-6b")           -> full ModelConfig
    smoke_config("yi-6b")         -> reduced same-family config (CPU tests)
    input_specs(cfg, "train_4k")  -> meta-tensor stand-ins for the dry-run
"""
from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import SHAPES, shape_applicable, smoke_reduce
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of

_DIR = os.path.dirname(__file__)
_EXCLUDE = {"__init__.py", "base.py"}

__all__ = ["SHAPES", "SHAPE_NAMES", "applicable", "get_config",
           "input_specs", "list_archs", "smoke_config"]


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


def input_specs(cfg: ModelConfig, shape: str, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict:
    """Stand-ins for every model input of the given shape cell: ``meta``
    tensors of the JAX package's shapes and dtypes (no memory, no values).
    JAX's ``pos`` is a weakly typed int32 scalar; torch has no weak types,
    so it is a plain int32 scalar here.

    Returns {"kind": train|prefill|decode, "batch": {...}, "seq": S,
             "global_batch": B}.
    """
    info = SHAPES[shape]
    b = batch or info["batch"]
    s = seq or info["seq"]
    kind = info["kind"]
    i32 = torch.int32
    dt = dtype_of(cfg)

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    specs: Dict[str, torch.Tensor] = {}
    if kind in ("train", "prefill"):
        specs["tokens"] = spec((b, s), i32)
        if kind == "train":
            specs["labels"] = spec((b, s), i32)
        if cfg.enc_layers:
            specs["frames"] = spec((b, cfg.num_audio_frames, cfg.d_model), dt)
        if cfg.cross_every and not cfg.enc_layers:
            specs["patches"] = spec((b, cfg.num_image_tokens, cfg.d_model),
                                    dt)
    else:  # decode: one new token against a seq-long cache
        specs["token"] = spec((b,), i32)
        specs["pos"] = spec((), i32)
    return {"kind": kind, "batch": specs, "seq": s, "global_batch": b}


def applicable(cfg: ModelConfig, shape: str):
    return shape_applicable(cfg, shape)


SHAPE_NAMES = list(SHAPES.keys())
