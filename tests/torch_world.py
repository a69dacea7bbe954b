"""A local ``torch.distributed`` world for the port's multi-process tests.

``World(2)`` spawns two processes that join a gloo group through a file
(``init_method="file://..."``: no network) and then run, each on its own
rank, whatever function the test names as ``"module:function"``;
``world.run`` returns every rank's result in rank order and raises with
the ranks' tracebacks when one fails. One world serves a whole test
module, since each process start costs seconds. The tasks below import
only torch, numpy and ``repro_torch``: the ranks never load JAX.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import shutil
import tempfile
import traceback

import numpy as np

TIMEOUT_S = 240


def _serve(rank: int, size: int, init: str, conn) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while (msg := conn.recv()) is not None:
            name, args, kwargs = msg
            module, fn = name.split(":")
            try:
                fn = getattr(importlib.import_module(module), fn)
                conn.send((True, fn(*args, **kwargs)))
            except Exception:
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` spawned ranks in one gloo group (see the module doc)."""

    def __init__(self, size: int = 2):
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self._dir = tempfile.mkdtemp(prefix="torch_world_")
        init = "file://" + os.path.join(self._dir, "init")
        self._conns, self._procs = [], []
        for rank in range(size):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(rank, size, init, there),
                               daemon=True)
            proc.start()
            self._conns.append(here)
            self._procs.append(proc)

    def run(self, name: str, *args, **kwargs) -> list:
        """Call ``name`` on every rank with the same arguments."""
        for conn in self._conns:
            conn.send((name, args, kwargs))
        results, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(TIMEOUT_S):
                self.close()
                raise TimeoutError(f"rank {rank} gave no answer to {name} "
                                   f"in {TIMEOUT_S} s")
            ok, value = conn.recv()
            results.append(value)
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{name} failed\n" + "\n".join(errors))
        return results

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
        shutil.rmtree(self._dir, ignore_errors=True)


# ------------------------------------------------------------- tasks ----
def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def walks(graph, plan_kw: dict, seed: int = 0, starts=None):
    """The sharded backend's walks and stats on this rank."""
    from repro_torch.engine import WalkEngine, WalkPlan
    eng = WalkEngine.build(graph, WalkPlan(backend="sharded", **plan_kw),
                           device="cpu")
    res = eng.run(starts=starts, seed=seed)
    return res.walks, res.stats, eng.capacity


def updated_walks(spec: str, plan_kw: dict, add, remove, seed: int):
    """Walks after ``update`` on the sharded backend, beside a sharded
    engine built fresh on the patched store, and the update's report."""
    from repro_torch.data.deltas import DeltaBatch
    from repro_torch.data.store import open_graph
    from repro_torch.engine import WalkEngine, WalkPlan
    plan = WalkPlan(backend="sharded", **plan_kw)
    eng = WalkEngine.build(spec, plan, device="cpu")
    rep = eng.update(DeltaBatch.build(add=add, remove=remove))
    st = open_graph(spec)
    st.apply(DeltaBatch.build(add=add, remove=remove))
    fresh = WalkEngine.build(st, plan, device="cpu")
    return (eng.run(seed=seed).walks, fresh.run(seed=seed).walks,
            (rep.relayout, rep.invalidated_device_shards,
             rep.hot_rows_updated, rep.device_shards))


def crashed_rounds(spec: str, cfg_kw: dict, ckpt_dir: str, rounds: int):
    """A sharded runner over the world that stops after ``rounds`` rounds
    (rank 0 writes the checkpoint)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.node2vec import Node2VecConfig
    from repro_torch.data.store import open_graph
    from repro_torch.launch.mesh import make_rw_mesh
    from repro_torch.runtime.fault_tolerance import WalkRoundRunner
    ck = Checkpointer(ckpt_dir)
    runner = WalkRoundRunner(open_graph(spec).graph, Node2VecConfig(**cfg_kw),
                             mesh=make_rw_mesh(device="cpu"),
                             checkpointer=ck, device="cpu")
    it = runner.rounds()
    got = [next(it) for _ in range(rounds)]
    ck.wait()
    return got, runner.stats_summary()


def resumed_rounds(spec: str, cfg_kw: dict, ckpt_dir: str,
                   rank_dirs: bool = False):
    """Every round of a sharded runner over the world that resumes from
    ``ckpt_dir``; with ``rank_dirs`` each rank past 0 reads a directory of
    its own (empty), as ranks on hosts that share no file system."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.node2vec import Node2VecConfig
    from repro_torch.data.store import open_graph
    from repro_torch.launch.mesh import make_rw_mesh
    from repro_torch.runtime.fault_tolerance import WalkRoundRunner
    if rank_dirs and rank():
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank()}")
    runner = WalkRoundRunner(open_graph(spec).graph, Node2VecConfig(**cfg_kw),
                             mesh=make_rw_mesh(device="cpu"),
                             checkpointer=Checkpointer(ckpt_dir),
                             device="cpu")
    return runner.completed_rounds(), list(runner.rounds())


def mesh_groups():
    """Which meshes share a process group: walk meshes share one, table
    meshes over the same ranks another, a prefix table mesh a third."""
    from repro_torch.engine import WalkEngine, WalkPlan
    from repro_torch.launch.mesh import make_rw_mesh, make_table_mesh
    from repro_torch.train.stream import StreamingSGNSTrainer
    rw = make_rw_mesh(device="cpu")
    table = make_table_mesh(rw)
    prefix = make_table_mesh(max_shards=1, device="cpu")
    engines = [WalkEngine.build("wec:k=5,deg=4", WalkPlan(
        backend="sharded", length=3), device="cpu") for _ in range(2)]
    trainer = StreamingSGNSTrainer(32, dim=4, shard_tables=True,
                                   device="cpu")
    return {"walk_shared": all(e.mesh.group is rw.group for e in engines)
            and make_rw_mesh(device="cpu").group is rw.group,
            "table_shared": trainer.mesh.group is table.group
            and make_table_mesh(device="cpu").group is table.group,
            "apart": table.group is not rw.group,
            "prefix": (prefix.rank, prefix.group is None
                       or prefix.group not in (rw.group, table.group))}


def epoch(params, state, args: dict, kw: dict):
    """``train_epoch_sharded`` on this rank's blocks of the world's table
    mesh; returns the gathered tables and moments and the losses."""
    import torch
    from repro_torch.launch.mesh import make_table_mesh
    from repro_torch.optim.optimizers import AdamState, adam_rows
    from repro_torch.train.shard import (gather_tables, shard_params,
                                         train_epoch_sharded)
    mesh = make_table_mesh(device="cpu")
    vocab = params["emb_in"].shape[0]
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    p = shard_params(t, vocab, mesh.size, mesh.rank)
    st = AdamState(torch.tensor(state["count"]),
                   shard_params({k: torch.from_numpy(v)
                                 for k, v in state["mu"].items()},
                                vocab, mesh.size, mesh.rank),
                   shard_params({k: torch.from_numpy(v)
                                 for k, v in state["nu"].items()},
                                vocab, mesh.size, mesh.rank))
    a = {k: torch.from_numpy(v) for k, v in args.items()}
    p2, s2, losses = train_epoch_sharded(
        p, st, a["c"], a["x"], a["valid"], a["perm2d"], a["prob"],
        a["alias"], a["key"], opt=adam_rows(kw.pop("lr")), mesh=mesh, **kw)

    def host(tree):
        return {k: v.numpy() for k, v in gather_tables(tree, mesh).items()}
    return host(p2), host(s2.mu), host(s2.nu), losses.numpy()


def trainer(vocab: int, rounds, kw: dict, max_shards=None):
    """A sharded ``StreamingSGNSTrainer`` over the world's table mesh (or
    its first ``max_shards`` ranks): embeddings, whole tables, losses and
    the world's size as ``world_shards`` reads it."""
    from repro_torch.launch.mesh import make_table_mesh
    from repro_torch.train.shard import world_shards
    from repro_torch.train.stream import StreamingSGNSTrainer
    mesh = make_table_mesh(max_shards=max_shards, device="cpu")
    tr = StreamingSGNSTrainer(vocab, shard_tables=True, mesh=mesh,
                              device="cpu", **kw)
    emb, st = tr.train(iter(rounds))
    tables = {k: v.numpy() for k, v in tr.tables().items()}
    return emb, tables, tr.loss_history(), st.shards, world_shards()


def launcher(argv: list) -> np.ndarray:
    """``repro_torch.launch.train.main`` inside the world."""
    from repro_torch.launch import train
    return train.main(argv)


def compressed_psum(grads_by_rank: list, residuals_by_rank: list):
    """``grad_utils.compressed_psum`` over the world, each rank with its own
    grads and residuals (lists of numpy trees, indexed by rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim.grad_utils import compressed_psum as psum
    r = dist.get_rank()

    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in t.items()}

    def host(t):
        return {k: host(v) if isinstance(v, dict) else v.numpy()
                for k, v in t.items()}
    g, res = psum(tree(grads_by_rank[r]), tree(residuals_by_rank[r]),
                  group=dist.group.WORLD)
    return host(g), host(res)


def sharded_batches(batches: list):
    """``data.pipeline.shard_batches`` at this rank of the world, on the
    CPU: every batch's arrays as numpy."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import shard_batches
    out = shard_batches(iter(batches), "cpu", rank=dist.get_rank(),
                        world=dist.get_world_size())
    return [{k: v.numpy() for k, v in b.items()} for b in out]


def example(path: str, argv: list):
    """Run an example script's ``main(argv)`` on this rank; returns (its
    result, what it printed)."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location("example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = mod.main(argv)
    return result, printed.getvalue()
