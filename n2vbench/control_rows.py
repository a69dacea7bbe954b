"""The row-Adam checks' control and planted faults, read at a cell's own
size.

    python3 n2vbench/control_rows.py --workload <cell> --seeds 1 2 3
                                     [--walkers N] [--device cuda]

For each seed it builds the cell's graph as a run does, walks the first
round with the reference, and puts in the program's place the row-Adam
reference (``reference_rows.py``) computed one precision lower (bfloat16
for the configuration's float32) and with each planted fault
(``reference_rows.FAULTS``: half of the batch left out with the mean over
the rest, the tables left unchanged, dense Adam in place of lazy). Each
is compared with the float64 reference by the run's own comparisons
(``checks_rows.py``), as are the walks in bfloat16 (``control.py``). A
control or fault that the checks pass is a check that cannot see it. One
JSON line a seed.

The benchmark's runs never run this; it reads the upper ends of the
limits (PERF.md gives them).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def train_controls(g, config: dict, mix: dict, seeds: dict, rng) -> dict:
    """The bf16 reference and the planted faults against the float64
    reference over the whole first round."""
    import torch

    from n2vbench import checks, checks_rows, reference, reference_rows
    w = int(mix["walkers_per_round"])
    starts = rng.permutation(g.n)[:w]
    walk0 = torch.from_numpy(checks.first_round_walks(
        g, config["plan"], seeds["walk"], starts)).to(g.row_ptr.device)
    cfg = checks_rows.rows_config(g, config, config["trainer"])
    init = dict(zip(reference_rows.TABLES, reference.init_tables(
        seeds["train"], cfg["vocab"], cfg["dim"], walk0.device)))
    t0 = time.perf_counter()
    want = reference_rows.sgns_rows_steps([walk0], cfg, seeds["train"])
    out = {"reference_s": time.perf_counter() - t0,
           "named": {n: int(m.sum()) for n, m in want["named"].items()}}
    variants = {"bf16": dict(dtype=torch.bfloat16)}
    variants.update((f, dict(fault=f)) for f in reference_rows.FAULTS)
    for name, kw in variants.items():
        got = reference_rows.sgns_rows_steps([walk0], cfg, seeds["train"],
                                             **kw)
        out[name] = checks_rows.gaps(got, want, init)
        del got
    out["reference"] = {"losses": want["losses"][:checks.FIRST],
                        "last_loss": want["losses"][-1]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--walkers", type=int, default=2048,
                    help="walks the walk control compares (a run's sample)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from n2vbench import control, graphs, harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_of(bench, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        seeds = harness.sub_seeds(seed)
        g = graphs.rmat_graph(cell.config, seeds["graph"], device)
        rng = np.random.default_rng(seeds["sample"])
        line = {"workload": args.workload, "seed": seed}
        line["walk_bf16"] = control.walk_control(
            g, cell.config["plan"], seeds["walk"], args.walkers, rng)
        line.update(train_controls(g, cell.config, cell.mix, seeds, rng))
        print(json.dumps(line), flush=True)
        del g
    return 0


if __name__ == "__main__":
    sys.exit(main())
