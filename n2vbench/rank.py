"""A rank other than 0 of a cell of more than one chip: joins the world
that rank 0 (``run.py``, through ``harness.run_world``) opened, runs the
same set-up, window and traces on its own chip, and prints nothing.

    python3 n2vbench/rank.py '<json: cell, seed, seconds, trace, kind,
                                init, size, rank>'
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv) -> int:
    from n2vbench import harness
    spec = json.loads(argv[0])
    cell = harness.Cell(**spec["cell"])
    device = harness.device_of(spec["kind"], spec["rank"])
    harness.join_world(spec["init"], spec["rank"], spec["size"], device)
    harness.run(cell, spec["seed"], spec["seconds"], spec["trace"], device,
                T_START, log=lambda *_: None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
