"""Dry-run of the paper's own computation: the distributed Fast-Node2Vec
superstep on a 512-shard world at WeC-26 scale (2^26 vertices, average
degree ~100, maximum degree ~2.8k — paper Table 1), without building the
graph — port of ``repro.launch.dryrun_walk``.

Every array of shard 0's ``ShardedGraph`` is a ``meta`` tensor of its
shape, and ``engine.analyze_sharded`` reads the superstep's terms from the
shapes alone, in one process with no world (the JAX package lowers and
compiles on 512 placeholder devices instead, and reads the compiled
program).

Cells (the paper's algorithm progression, §3.4):
  fn_base    cap = max_degree, no hot set        (paper FN-Base)
  fn_cache   cap = 128, hot tail replicated      (paper FN-Cache)
  fn_approx  fn_cache + O(1) alias at hot v      (paper FN-Approx)
plus the JAX package's beyond-paper variants (O(1) alias always at hot
vertices, a visit-aware request capacity, bf16 exchange weights).

The collective term is the NEIG-message volume the paper's Figs. 4/14
measure: one superstep's ``walk_exchange_bytes`` per device.

  python -m repro_torch.launch.dryrun_walk [--cell fn_base]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.walk_distributed import ShardedGraph
from repro_torch.engine import WalkPlan
from repro_torch.engine.engine import analyze_sharded

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_walk_torch"

# WeC-26 scale (paper Table 1: |V|=2^26, avg deg 100, max deg 2771)
N = 1 << 26
MAX_DEG = 2816          # max degree rounded up to a lane multiple
SHARDS = 512
ROUNDS = 8              # FN-Multi: walkers per round = N / ROUNDS
W_LOCAL = N // ROUNDS // SHARDS
HOT_K = 1 << 15         # replicated hot rows (32k x hot_cap x 8B ~ 0.7GB)


def abstract_graph(cap: int, hot_cap: int,
                   dtype_w: torch.dtype = torch.float32) -> ShardedGraph:
    """Shard 0 of the WeC-26 layout on ``meta``: its row block [N / SHARDS,
    cap] and the replicated hot pack."""
    n_local = N // SHARDS

    def sds(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    i32, f32 = torch.int32, torch.float32
    return ShardedGraph(
        n=N, n_orig=N, num_shards=SHARDS, rank=0, cap=cap, hot_cap=hot_cap,
        adj=sds((n_local, cap), i32), wgt=sds((n_local, cap), dtype_w),
        alias_p=sds((n_local, cap), f32),
        alias_i=sds((n_local, cap), i32),
        deg=sds((n_local,), i32),
        hot_ids=sds((HOT_K,), i32),
        hot_adj=sds((HOT_K, hot_cap), i32),
        hot_wgt=sds((HOT_K, hot_cap), dtype_w),
        hot_alias_p=sds((HOT_K, hot_cap), f32),
        hot_alias_i=sds((HOT_K, hot_cap), i32),
        hot_deg=sds((HOT_K,), i32),
        hot_wmin=sds((HOT_K,), f32),
        hot_wmax=sds((HOT_K,), f32))


CELLS = {
    # name: (cap, hot_cap, mode, capacity_per_dest)
    "fn_base": (MAX_DEG, MAX_DEG, "exact", 4 * W_LOCAL // SHARDS),
    "fn_cache": (128, MAX_DEG, "exact", 4 * W_LOCAL // SHARDS),
    "fn_approx": (128, MAX_DEG, "approx", 4 * W_LOCAL // SHARDS),
    "fn_approx_always": (128, MAX_DEG, "approx_always",
                         4 * W_LOCAL // SHARDS),
    "fn_approx_visitcap": (128, MAX_DEG, "approx_always",
                           2 * W_LOCAL // SHARDS),
    "fn_approx_bf16": (128, MAX_DEG, "approx_always",
                       2 * W_LOCAL // SHARDS),
}


def run_cell(name: str, length: int = 4, save: bool = True) -> dict:
    cap, hot_cap, mode, capacity = CELLS[name]
    dtype_w = torch.bfloat16 if name.endswith("bf16") else torch.float32
    g = abstract_graph(cap, hot_cap, dtype_w)
    plan = WalkPlan(p=0.5, q=2.0, length=length, mode=mode, approx_eps=1e-3,
                    backend="sharded", capacity=capacity)
    art = analyze_sharded(g, plan, capacity, num_walkers=W_LOCAL * SHARDS)
    art["cell"] = name
    art["bottleneck"] = ("collective" if art["t_collective"] >
                         art["t_compute"] else "compute")
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        (ART_DIR / f"{name}.json").write_text(json.dumps(art, indent=1))
    return art


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    args = ap.parse_args(argv)
    cells = [args.cell] if args.cell else list(CELLS)
    print(f"{'cell':22s} {'t_compute':>10s} {'t_collective':>12s} "
          f"{'coll GiB/step':>13s} {'dominant':>10s}")
    for c in cells:
        a = run_cell(c)
        print(f"{c:22s} {a['t_compute']:10.3e} {a['t_collective']:12.3e} "
              f"{a['coll_bytes_per_step_per_dev'] / 2**30:13.3f} "
              f"{a['bottleneck']:>10s}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
