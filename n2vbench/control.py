"""The checks' controls and planted faults, read at a cell's own size.

    python3 n2vbench/control.py --workload <cell> --seeds 1 2 3
                                [--walkers N] [--device cuda]

For each seed it builds the cell's graph as a run does and puts, in the
program's place, the reference computed one precision lower (bfloat16 for
the configuration's float32) and, for a training cell, the reference with
each fault a training step can have planted in it: half of the batch left
out with the mean taken over the rest, and a step that leaves the tables
unchanged. Each is compared with the reference by the run's own
comparisons (``checks.py``). A control or fault that the checks pass is a
check that cannot see it. One JSON line a seed and variant.

The benchmark's runs never run this; it reads the upper ends of the
limits (PERF.md gives them).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def walk_control(g, plan: dict, seed: int, walkers: int, rng) -> dict:
    """The bf16 reference's walks against the float32 reference's, for
    ``walkers`` walkers drawn as a run draws its sample."""
    import numpy as np
    import torch

    from n2vbench import checks
    from n2vbench.reference import MASK
    starts = rng.integers(0, g.n, walkers).astype(np.int64)
    sample = [(np.full(walkers, seed & MASK, np.int64), starts,
               rng.permutation(walkers).astype(np.int64), None)]
    want = checks.sampled_walks(g, plan, sample)
    got = checks.sampled_walks(g, plan, sample, torch.bfloat16)
    return checks.walk_gaps(got, want)


def train_controls(g, config: dict, mix: dict, seeds: dict, rng) -> dict:
    """The bf16 reference and the planted faults against the float64
    reference over the whole first round."""
    import time

    import torch

    from n2vbench import checks, reference
    w = int(mix["walkers_per_round"])
    starts = rng.permutation(g.n)[:w]
    walk0 = torch.from_numpy(checks.first_round_walks(
        g, config["plan"], seeds["walk"], starts)).to(g.row_ptr.device)
    scfg = checks.sgns_config(g, config, config["trainer"])
    t0 = time.perf_counter()
    want = reference.sgns_steps(walk0, scfg, seeds["train"])
    out = {"reference_s": time.perf_counter() - t0}
    variants = {"bf16": dict(dtype=torch.bfloat16),
                "half_batch": dict(fault="half_batch"),
                "frozen": dict(fault="frozen")}
    for name, kw in variants.items():
        got = reference.sgns_steps(walk0, scfg, seeds["train"], **kw)
        out[name] = checks.sgns_gaps(checks.reference_readings(got), want)
    out["reference"] = {"losses": want["losses"][:checks.FIRST],
                        "last_loss": want["losses"][-1],
                        "grads": want["grads"], "change": want["change"],
                        "round_change": want["round_change"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--walkers", type=int, default=2048,
                    help="walks a walk control compares (a run's sample)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from n2vbench import graphs, harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_of(bench, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        seeds = harness.sub_seeds(seed)
        g = graphs.rmat_graph(cell.config, seeds["graph"], device)
        rng = np.random.default_rng(seeds["sample"])
        line = {"workload": args.workload, "seed": seed}
        line["walk_bf16"] = walk_control(g, cell.config["plan"],
                                         seeds["walk"], args.walkers, rng)
        if cell.mix["kind"] == "train_stream":
            line.update(train_controls(g, cell.config, cell.mix, seeds,
                                       rng))
        print(json.dumps(line), flush=True)
        del g
    return 0


if __name__ == "__main__":
    sys.exit(main())
