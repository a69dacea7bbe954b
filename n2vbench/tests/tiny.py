"""Tiny cells for the CPU tests: the committed cells' files with the scale
cut to a graph of 2^7 vertices, short walks and a small table."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from n2vbench import harness  # noqa: E402

CELLS = ("er20-walk-rounds", "wec17-walk-fncache", "er20-train",
         "er20-walk-whole")


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> harness.Cell:
    c = harness.cell_of(bench(), name)
    c.config.update(k=7, avg_degree=float(c.config["avg_degree"]) / 4)
    c.config["plan"]["length"] = 12
    if c.config["plan"]["cap"]:
        c.config["plan"]["cap"] = 16
    c.config["trainer"].update(dim=16, batch_size=512)
    c.mix.update(walkers_per_round=64, check_walkers=16, walks_per_vertex=2)
    return c


def run(name: str, seed: int = 2 ** 31 + 77, trace: bool = False,
        seconds: float = 0.5) -> dict:
    import time
    return harness.run(cell(name), seed, seconds, trace, "cpu",
                       time.perf_counter(), log=lambda *_: None)
