"""Roofline terms of a dry-run cell — port of ``repro.roofline.analysis``.

Per (arch x shape x mesh) cell, in seconds, per device:

    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective bytes / LINK_BW

The FLOPs are counted by :func:`count_flops`, which runs the step under
``torch.utils.flop_counter.FlopCounterMode`` (on ``meta`` tensors in the
dry-run: nothing is computed): matrix products, convolutions and the
flash kernel's own formula (``kernels.flash_attention``), not elementwise
work. The bytes are ``roofline.traffic.analytic_bytes``. The rates are one
NVIDIA H100 SXM 80GB's (``roofline.traffic``: bf16 tensor cores, HBM3,
NVLink one way).

Not carried from the JAX module, which reads XLA's compiled program: its
``cost_dict`` (the normaliser of ``compiled.cost_analysis()``) and
``collective_bytes`` (operand bytes of the collectives in optimized HLO
text). The port has no HLO: an LM cell's collective term is ``None``
(there is no SPMD program to read, and an analytic count of the ZeRO-3 /
TP scheme would be a model the JAX package does not have), and the
bottleneck is taken over the terms that exist. The walk cells keep their
analytic exchange term (``engine.analyze_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline.traffic import (H100_BF16_FLOPS, H100_HBM_BW,
                                          H100_NVLINK_BW)

PEAK_FLOPS = H100_BF16_FLOPS     # FLOP/s per card
HBM_BW = H100_HBM_BW             # bytes/s per card
LINK_BW = H100_NVLINK_BW         # bytes/s per card, one way


def count_flops(fn: Callable, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` under ``FlopCounterMode``; returns
    ``{"flops": total, "by_op": {op name: flops}, "out": fn's result}``."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    return {"flops": float(counter.get_total_flops()), "by_op": by_op,
            "out": out}


@dataclasses.dataclass
class Roofline:
    """Per-device terms of one cell: ``hlo_flops`` and ``hlo_bytes`` keep
    the JAX field names (here counted FLOPs and analytic bytes), so
    ``t_compute = hlo_flops / PEAK_FLOPS``. ``coll_bytes=None`` (an LM
    cell) leaves ``t_collective`` None and out of the bottleneck."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # per device
    hlo_bytes: float           # per device
    coll_bytes: Optional[float]    # per device
    coll_by_op: Optional[Dict[str, int]]
    model_flops: float         # global (6*N*D)
    per_device_mem: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        return None if self.coll_bytes is None else self.coll_bytes / LINK_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs of all cards (catches remat
        recompute, replication and routing waste)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Ideal compute-only time over the largest term (the score)."""
        t = max(self._terms().values())
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / t if t > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "coll_bytes": self.coll_bytes,
            "coll_by_op": self.coll_by_op, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_mem": self.per_device_mem,
        }


def extrapolate(c1: dict, c2: dict, n: int) -> dict:
    """cost(N) = c1 + (N-1)*(c2 - c1), per numeric key (homogeneous stack)."""
    out = {}
    for k in c1:
        v1 = c1.get(k, 0)
        v2 = c2.get(k, 0)
        if isinstance(v1, dict):
            out[k] = extrapolate(v1, v2 if isinstance(v2, dict) else {}, n)
        else:
            out[k] = (v1 or 0) + (n - 1) * ((v2 or 0) - (v1 or 0))
    return out


def model_flops_for(cfg, kind: str, seq: int, global_batch: int) -> float:
    """6*N*D (dense) / 6*N_active*D for training; 2*N*D forward-only.
    D = processed tokens. Decode processes one token per call."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * global_batch
        return 2.0 * n_active * tokens
    tokens = global_batch  # decode: one new token per sequence
    return 2.0 * n_active * tokens
