"""Distributed Fast-Node2Vec across the ranks of a ``torch.distributed``
world, with a mid-run "node failure" and an elastic resume on FEWER ranks
— the FN-Multi fault-tolerance story end to end, all through the unified
WalkEngine API (the runner builds a ``backend="sharded"`` engine once and
reuses it across rounds). The PyTorch port of
``examples/distributed_walks.py``.

Where the JAX example simulates 8 devices in one process, this is one
program per rank, like the port's training launcher in a world: run it
under ``torchrun`` (NCCL, one card a rank; gloo with ``--device cpu``), or
call ``main`` on every rank of a world the caller started (the tests run
it in a gloo world of two). Alone it is a world of one rank, which
resumes on that rank. Every rank walks its row block and gets every
walk back; rank 0 alone prints and writes the checkpoint, so the ranks
need one ``--ckpt-dir`` (emptied when the example starts):

    PYTHONPATH=src torchrun --nproc_per_node=N \\
        examples/torch/distributed_walks.py
    PYTHONPATH=src python examples/torch/distributed_walks.py [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine
from repro_torch.launch.mesh import RwMesh, make_rw_mesh
from repro_torch.launch.train import start_world
from repro_torch.runtime.balance import shard_balance
from repro_torch.runtime.fault_tolerance import (WalkRoundRunner,
                                                 elastic_restart)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_walks"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    started = start_world(device)
    try:
        return walk_and_resume(device, args.ckpt_dir)
    finally:
        if started:
            dist.destroy_process_group()


def walk_and_resume(device, ckpt_dir: str) -> dict:
    mesh = make_rw_mesh(device=device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    def barrier():
        if mesh.group is not None:
            dist.barrier(group=mesh.group)

    # degree-descending relabel: hubs become the contiguous id prefix, so
    # the range partition below spreads FN-Cache hot rows evenly across
    # shards
    graph = open_graph("skew:s=3,k=10,deg=25,seed=0,relabel=degree").graph
    say(f"graph: {graph.n} vertices, {graph.m} edges, "
        f"max degree {graph.max_degree}")
    rep = shard_balance(graph, num_shards=8, cap=32)
    say(f"shard balance: raw edge imbalance {rep.edge_imbalance:.2f}x, "
        f"post-cap work imbalance {rep.capped_imbalance:.2f}x")

    cfg = Node2VecConfig(p=0.5, q=2.0, walk_length=20, num_walks=3, cap=32,
                         seed=7)

    # one-off engine run: the structured stats of the sharded walk
    eng = WalkEngine.build(graph, cfg.plan(mesh), mesh=mesh)
    res = eng.run(seed=7)
    say(f"engine stats: ranks={mesh.size} dropped={res.stats.dropped} "
        f"supersteps={res.stats.supersteps} "
        f"collective~{res.stats.collective_bytes / 2**20:.1f} MiB/rank "
        f"(analytic NEIG estimate)")

    if mesh.rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    barrier()
    ck = Checkpointer(ckpt_dir)

    runner = WalkRoundRunner(graph, cfg, mesh=mesh, checkpointer=ck)
    it = runner.rounds()
    first = [next(it), next(it)]
    say("round 0:", first[0].shape)
    say("round 1:", first[1].shape)
    del it, runner          # simulate a crash after 2 of 3 rounds
    ck.wait()
    barrier()

    # elastic resume on FEWER ranks (rank 0 alone, a world of one): same
    # walks, bit-identical
    rounds = []
    if mesh.rank == 0:
        alone = RwMesh(group=None, rank=0, size=1, device=mesh.device)
        resumed = elastic_restart(graph, cfg, Checkpointer(ckpt_dir),
                                  new_mesh=alone)
        rounds = list(resumed.rounds())
        if any(not np.array_equal(a, b) for a, b in zip(first, rounds)):
            raise RuntimeError("the resumed rounds differ from the first")
        say(f"resumed on 1 of {mesh.size} ranks: {len(rounds)} rounds, "
            f"{rounds[-1].shape[0]} walks each")
    barrier()
    say("fault-tolerant, elastic, deterministic: OK")
    return {"walks": res.walks, "first": first, "rounds": rounds}


if __name__ == "__main__":
    main()
