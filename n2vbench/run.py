"""The port's benchmark: one run of one cell.

    python3 n2vbench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Reads ``BENCHMARK.json`` beside this folder, builds the cell's inputs from
the seed, sets up the port (``src/repro_torch``), measures for
``--seconds`` (``--trace 1``: traces the mix's ``trace_units`` instead and
reports the per-layer metrics), checks what the window produced against
``reference.py``, and prints one JSON line last on standard output. The
compared numbers and their limits are the last lines on standard error.
A cell of more than one chip starts one ``rank.py`` process a further
chip.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from n2vbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_world(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(device),
                       "count": cell.chips,
                       "memory_peak_bytes": out["memory_peak"]}}
    if args.trace:
        line["device"]["busy_s"] = out["busy_s"]
        line["device"]["window_s"] = out["window_s"]
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
