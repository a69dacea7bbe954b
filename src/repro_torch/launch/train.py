"""Training launcher — port of ``repro.launch.train``.

Two tasks, selected by ``--task``: ``node2vec`` (the default) and ``lm``.

``node2vec`` is the paper's pipeline end to end: a graph spec (an on-disk
edge list with a memmapped CSR cache, or a synthetic family) -> FN-Multi
walk rounds, checkpointed -> SGNS embeddings ->
``<ckpt-dir>/embeddings.npy``. Stage 2 streams: the trainer optimizes each round as it arrives, on the dense
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

``lm`` trains an architecture of the model zoo (``--arch``; ``--smoke``
for its reduced config) on token sequences packed from node2vec walks:
``WalkEngine`` walks of length 64 (p = q = 1) over ``--graph`` (default a
WeC graph), taken modulo the vocabulary, cut into ``--seq`` + 1 tokens.
Each step draws ``--batch`` sequences with ``np.random.default_rng(--seed)``
and runs ``loss_fn``'s grads (autograd), ``clip_by_global_norm(., 1.0)``,
AdamW and ``apply_updates``. ``(params, opt_state)`` are checkpointed
every ``--ckpt-every`` steps and at ``--steps``; a second run on the same
``--ckpt-dir`` resumes. As in the JAX launcher, a resumed run draws its
batches from the seed again (so it is not the uninterrupted run), and the
checkpoint labelled step s (``--ckpt-every``) holds s + 1 updates. A
resume at ``--steps`` or past it runs no step and writes nothing. It runs
in one process, as the JAX launcher's ``run_lm`` runs on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --task lm \\
      --arch yi-6b --smoke --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.node2vec import Node2VecConfig, train_embeddings
from repro_torch.data.corpus import walks_to_lm_tokens
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.launch.mesh import make_rw_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.grad_utils import clip_by_global_norm, value_and_grad
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates
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


def lm_corpus(args, cfg: ModelConfig) -> np.ndarray:
    """[N, seq + 1] token sequences from walks over ``--graph`` (default
    ``wec:k=max(--k, 8),deg=10``) on ``args.device``."""
    spec = args.graph or f"wec:k={max(args.k, 8)},deg=10,seed={args.seed}"
    g = open_graph(spec, cache_dir=args.graph_cache).graph
    walks = WalkEngine.build(g, WalkPlan(p=1.0, q=1.0, length=64),
                             device=args.device).run(seed=args.seed).walks
    return walks_to_lm_tokens(walks % cfg.vocab, args.seq + 1)


def lm_train_step(cfg: ModelConfig, opt: Optimizer, params: dict, opt_state,
                  batch: dict):
    """One step: the loss and its grads, clipped to global norm 1, then the
    optimizer's update. Returns (params, opt_state, loss, grad norm before
    clipping); the inputs are not changed."""
    loss, grads = value_and_grad(lambda p, b: M.loss_fn(cfg, p, b), params,
                                 batch)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss, gnorm


def run_lm(args, cfg: Optional[ModelConfig] = None,
           tokens: Optional[np.ndarray] = None) -> dict:
    """The ``lm`` task. A caller may pass ``cfg`` in place of
    ``--arch``/``--smoke`` (a config of its own, e.g. at cut depth) and
    ``tokens`` ([N, --seq + 1] sequences) in place of ``lm_corpus``'s
    walks. Returns the final ``params`` and ``opt_state``, the ``(params,
    opt_state)`` restored from the checkpoint (``restored``, None on a
    fresh start), ``start_step``, each step's ``losses`` and grad norms
    (``gnorms``) as floats, and ``step_end``: the host clock after each
    step (after the device finished it on the steps that print)."""
    dev = args.device
    if cfg is None:
        cfg = (configs.smoke_config(args.arch) if args.smoke
               else configs.get_config(args.arch))
    params = M.init_params(cfg, jr.PRNGKey(args.seed), dev)
    opt = adamw(lr=args.lr)
    opt_state = opt.init(params)
    ckpt = Checkpointer(args.ckpt_dir)
    start_step, restored = 0, None
    if ckpt.latest_step() is not None:
        restored, meta = ckpt.restore((params, opt_state))
        params, opt_state = restored
        start_step = meta["step"]
        print(f"resumed from step {start_step}")

    if tokens is None:
        tokens = lm_corpus(args, cfg)
    print(f"corpus: {tokens.shape[0]} sequences of {args.seq + 1} tokens")

    bsz = args.batch
    # the JAX launcher's draws: a resumed run starts them at the seed again
    rng = np.random.default_rng(args.seed)
    losses, gnorms, step_end = [], [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        idx = rng.integers(0, tokens.shape[0], size=bsz)
        seqs = torch.from_numpy(tokens[idx]).to(dev)
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        params, opt_state, loss, gnorm = lm_train_step(cfg, opt, params,
                                                       opt_state, batch)
        losses.append(loss)
        gnorms.append(gnorm)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.3f} ({dt:.1f}s)")
        step_end.append(time.perf_counter())
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            ckpt.save(step, (params, opt_state), blocking=False)
    if not losses:
        # the JAX launcher would save here and then read an unset loss
        print(f"no step ran: the checkpoint is at step {start_step} and "
              f"--steps is {args.steps}")
    else:
        ckpt.save(args.steps, (params, opt_state))
        print("done; final loss", float(losses[-1]))
    ckpt.wait()
    return {"params": params, "opt_state": opt_state, "restored": restored,
            "start_step": start_step,
            "losses": [float(x) for x in losses],
            "gnorms": [float(x) for x in gnorms], "step_end": step_end}


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
    """The JAX launcher's flags and defaults, plus ``--device``. The
    ``--ckpt-dir`` default is the port's own, under the temp dir
    (``TMPDIR``), so a run never resumes from the JAX package's
    checkpoints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["node2vec", "lm"], default="node2vec")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
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
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.device = resolve_device(args.device)
    started = start_world(args.device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if args.task == "lm":
            if world > 1:
                raise NotImplementedError(
                    "--task lm trains in one process, as the JAX "
                    "launcher's run_lm on one device; data-parallel LM "
                    "training is not carried")
            return run_lm(args)
        mesh = make_rw_mesh(device=args.device) if world > 1 else None
        if mesh is not None:
            args.device = mesh.device
        return run_node2vec(args, mesh)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
