"""Training launcher — port of ``repro.launch.train``'s ``node2vec`` task.

The paper's pipeline end to end: a graph spec (an on-disk edge list with a
memmapped CSR cache, or a synthetic family) -> FN-Multi walk rounds,
checkpointed -> SGNS embeddings -> ``<ckpt-dir>/embeddings.npy``. Stage 2
streams: the trainer optimizes each round as it arrives, on the dense
tables or with ``--shard-tables`` lazy row-Adam on each batch's unique rows
(``--sgns-backend fused``: the SGNS kernel); ``--concat`` collects every
round first and trains on the host corpus. A second run on the same
``--ckpt-dir`` resumes from the checkpointed rounds. Runs on the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --task node2vec \\
      --device cpu --graph edgelist:/path.txt --graph-cache DIR

In a ``torch.distributed`` world of more than one process the walks run
on the sharded backend and ``--shard-tables`` partitions the tables over
the same ranks (the JAX launcher's ``make_rw_mesh()`` on more than one
device). The world is the caller's default group when it has started
one; otherwise, under ``torchrun`` (``RANK``/``WORLD_SIZE``), the
launcher starts it, NCCL on ``cuda:LOCAL_RANK`` (gloo for ``--device
cpu``):

  PYTHONPATH=src torchrun --nproc_per_node=N -m repro_torch.launch.train \\
      --task node2vec --shard-tables

Every rank computes the same embeddings; rank 0 alone writes the
checkpoints and ``embeddings.npy`` while the others wait at a barrier. A
resume at world > 1 needs a ``--ckpt-dir`` that every rank reads (a
shared file system across hosts); the ranks refuse to resume from
different rounds.

``--task lm`` (LM training) is not ported yet: ROADMAP.md item 11b.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.node2vec import Node2VecConfig, train_embeddings
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_rw_mesh
from repro_torch.runtime.fault_tolerance import WalkRoundRunner
from repro_torch.train.stream import StreamingSGNSTrainer


def graph_spec(args) -> str:
    """``--graph`` wins; otherwise the --k/--avg-degree WeC knobs."""
    return args.graph or f"wec:k={args.k},deg={args.avg_degree:g}," \
                         f"seed={args.seed}"


def run_node2vec(args, mesh=None) -> np.ndarray:
    """The node2vec task; ``mesh`` (a world of more than one rank) shards
    the walks and, with ``--shard-tables``, the tables."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    g = open_graph(graph_spec(args), cache_dir=args.graph_cache).graph
    say(f"graph: {graph_spec(args)} -> n={g.n} m={g.m} "
        f"maxdeg={g.max_degree}")
    n2v = Node2VecConfig(p=args.p, q=args.q, walk_length=args.walk_length,
                         num_walks=args.rounds, dim=args.dim,
                         window=args.window, negatives=args.negatives,
                         batch_size=args.sgns_batch,
                         sgns_backend=args.sgns_backend,
                         mode=args.mode, cap=args.cap, seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir)
    runner = WalkRoundRunner(g, n2v, mesh=mesh, checkpointer=ckpt,
                             device=args.device)

    if args.concat:
        # generate-then-train: collect every round on the host, then train
        # on the host corpus
        walks = np.concatenate(list(runner.rounds()), axis=0)
        say(f"corpus: {walks.shape[0]} walks of {walks.shape[1]} steps")
        emb = train_embeddings(g, walks, n2v, device=args.device)
    else:
        trainer = StreamingSGNSTrainer.from_config(
            g.n, n2v, shard_tables=args.shard_tables, mesh=mesh,
            device=args.device)
        emb, ts = trainer.train(runner.rounds())
        say(f"train[{ts.backend}]: {ts.rounds} rounds, {ts.steps} steps, "
            f"{ts.pairs} pairs in {ts.wall_seconds:.1f}s "
            f"({ts.pairs_per_sec:.0f} pairs/s, "
            f"{ts.tokens_per_sec:.0f} tokens/s)")
        say(f"overlap: walk_wait {ts.walk_wait_seconds:.2f}s, "
            f"efficiency {ts.overlap_efficiency:.2f}; "
            f"h2d {ts.h2d_bytes} B vs {ts.h2d_bytes_concat} B staged")
        if ts.shards > 1:
            say(f"shards: {ts.shards} table shards, "
                f"collective {ts.collective_bytes} B "
                f"({ts.exposed_collective_bytes} B exposed)")
    out = os.path.join(args.ckpt_dir, "embeddings.npy")
    if lead:
        np.save(out, emb)
    if mesh is not None:
        dist.barrier(group=mesh.group)
    say(f"embeddings: {emb.shape} -> {out}")
    return emb


def start_world(device) -> bool:
    """Start the default group from ``torchrun``'s environment when the
    caller has not and ``WORLD_SIZE`` > 1: NCCL on ``cuda:LOCAL_RANK``,
    gloo on the CPU. Returns whether it started one."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def parser() -> argparse.ArgumentParser:
    """The JAX launcher's ``node2vec`` flags and defaults, plus
    ``--device``. The LM task's flags wait for its port (item 11b), so
    argparse rejects them. The ``--ckpt-dir`` default is the port's own,
    under the temp dir (``TMPDIR``), so a run never resumes from the JAX
    package's checkpoints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["node2vec", "lm"], default="node2vec")
    ap.add_argument("--graph", default=None,
                    help="dataset spec (repro_torch.data.store.open_graph): "
                         "'wec:k=12,deg=30', 'edgelist:/path/edges.txt', "
                         "'csr:/path/cache_dir', ... (overrides --k)")
    ap.add_argument("--graph-cache", default=None,
                    help="CSR cache dir for edgelist specs (build once, "
                         "memmap thereafter)")
    ap.add_argument("--k", type=int, default=10, help="RMAT log2 vertices")
    ap.add_argument("--avg-degree", type=float, default=20)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--walk-length", type=int, default=80)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--mode", choices=["exact", "approx"], default="exact")
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--negatives", type=int, default=5)
    ap.add_argument("--sgns-batch", type=int, default=1024,
                    help="SGNS batch size (fixed-shape device batches)")
    ap.add_argument("--sgns-backend", choices=["jnp", "fused"],
                    default="jnp",
                    help="stage-2 gradient backend: the closed form / "
                         "autograd, or the fused SGNS kernel")
    ap.add_argument("--concat", action="store_true",
                    help="generate-then-train baseline instead of the "
                         "streamed on-device trainer")
    ap.add_argument("--shard-tables", action="store_true",
                    help="lazy row-Adam on each batch's unique table rows, "
                         "the tables partitioned over the world's ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.task == "lm":
        raise NotImplementedError(
            "--task lm (LM training) is not ported yet: ROADMAP.md Queue 1 "
            "item 11b")
    args.device = resolve_device(args.device)
    started = start_world(args.device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_rw_mesh(device=args.device) if world > 1 else None
        if mesh is not None:
            args.device = mesh.device
        return run_node2vec(args, mesh)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
