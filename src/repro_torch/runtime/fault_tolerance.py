"""Fault tolerance and elastic scaling for the walk rounds — port of
``repro.runtime.fault_tolerance``.

FN-Multi rounds (the paper's k independent rounds, §3.4) are the fault
boundary: each completed round is checkpointed atomically, and a crashed
run resumes from the first incomplete round. Walker state is keyed by
vertex id and the RNG by (seed, round, walker, step), so a restart may
use another world size (:func:`elastic_restart`): the sharded layout is
rebuilt for it and resumed rounds equal uninterrupted ones bit for bit.
Edge deltas submitted mid-stream land between rounds
(:meth:`WalkRoundRunner.submit_update`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.deltas import DeltaBatch
from repro_torch.engine import WalkEngine, round_seed


class WalkRoundRunner:
    """Run FN-Multi walk rounds with checkpoint and resume.

    Round r walks every vertex once with seed ``round_seed(cfg.seed, r)``.
    The checkpoint holds the completed rounds' walks; :meth:`rounds` yields
    each round's walks as it completes (the streaming trainer's source).
    The engine is built once per runner, on the card unless given
    ``device="cpu"``, sharded over ``mesh`` when given one (every rank
    then runs the runner; rank 0 alone writes the checkpoint, so a resume
    at world > 1 needs a checkpoint directory that every rank reads: the
    ranks check that they resume from the same round). Exact rounds
    raise on a dropped request. Per-round :class:`WalkStats` are kept in
    ``round_stats``, and the dropped total rides in the checkpoint's meta,
    so a resumed run reports the totals of an unbroken one.
    """

    def __init__(self, g, cfg: Node2VecConfig, mesh=None,
                 checkpointer: Optional[Checkpointer] = None, device=None):
        self.g = g
        self.cfg = cfg
        self.ckpt = checkpointer
        # a dropped request silently skews an exact corpus: raise instead
        plan = cfg.plan(mesh)
        if cfg.mode == "exact":
            plan = dataclasses.replace(plan, strict_drops=True)
        self.engine = WalkEngine.build(g, plan, mesh=mesh, device=device)
        mesh = self.engine.mesh
        self._writes = mesh is None or mesh.rank == 0
        self.round_stats: dict = {}        # round -> WalkStats (this process)
        self.total_dropped = 0             # survives a resume via the meta
        self._pending_updates: list = []   # DeltaBatches queued mid-stream
        self.update_reports: list = []     # UpdateReport per drained queue

    def completed_rounds(self) -> int:
        if self.ckpt is None:
            return 0
        step = self.ckpt.latest_step()
        return 0 if step is None else step

    def _start(self) -> int:
        """The first round to walk: every rank reads the checkpoint, and
        one all-reduce (MAX of ``start`` and of ``-start``) checks that they
        read the same round before any rank walks."""
        start = self.completed_rounds()
        mesh = self.engine.mesh
        if mesh is None or mesh.group is None:
            return start
        t = torch.tensor([start, -start], dtype=torch.int64,
                         device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        hi, lo = int(t[0]), -int(t[1])
        if hi != lo:
            raise RuntimeError(
                f"the ranks read {lo} to {hi} completed rounds from their "
                f"checkpoints: a resume at world {mesh.size} needs one "
                f"checkpoint directory that every rank reads")
        return start

    def run_round(self, r: int) -> np.ndarray:
        res = self.engine.run(seed=round_seed(self.cfg.seed, r))
        self.round_stats[r] = res.stats
        self.total_dropped += res.stats.dropped
        return res.walks

    def submit_update(self, deltas) -> None:
        """Queue edge deltas to land *between* rounds.

        Batches are drained after the next round is yielded and applied
        through ``WalkEngine.update``. ``engine.rounds`` enqueues round
        ``r+1`` before round ``r`` is yielded, so an update submitted while
        round ``r`` is consumed first affects round ``r+2``; every round
        walks exactly one graph version (``WalkStats.graph_version``).
        Updates are not checkpointed.
        """
        batches = [deltas] if isinstance(deltas, DeltaBatch) else list(deltas)
        self._pending_updates.extend(batches)

    def _drain_updates(self) -> None:
        if not self._pending_updates:
            return
        batches, self._pending_updates = self._pending_updates, []
        self.update_reports.append(self.engine.update(batches))

    def stats_summary(self) -> dict:
        """Cumulative accounting over the yielded rounds (restored ones
        included): dropped requests and the plan's exposed-vs-total
        exchange bytes."""
        exposed = sum(s.exposed_collective_bytes
                      for s in self.round_stats.values())
        total = sum(s.collective_bytes for s in self.round_stats.values())
        return {"dropped": self.total_dropped,
                "exposed_collective_bytes": exposed,
                "collective_bytes": total,
                "overlap_efficiency":
                    1.0 - exposed / total if total else 0.0}

    def rounds(self) -> Iterator[np.ndarray]:
        n = self.engine.n
        start = self._start()
        done = []
        if start and self.ckpt is not None:
            (prev,), meta = self.ckpt.restore((np.zeros(
                (start * n, self.cfg.walk_length), np.int32),))
            self.total_dropped = int((meta or {}).get("dropped", 0))
            done = [prev[i * n:(i + 1) * n] for i in range(start)]
            for w in done:
                yield w
        # engine.rounds enqueues round r+1 before round r is copied to the
        # host, with the same per-round seeds as run_round(r)
        live = self.engine.rounds(self.cfg.num_walks, seed=self.cfg.seed,
                                  start=start)
        for r, res in zip(range(start, self.cfg.num_walks), live):
            self.round_stats[r] = s = res.stats
            self.total_dropped += s.dropped
            done.append(res.walks)
            if self.ckpt is not None and self._writes:
                self.ckpt.save(r + 1, (np.concatenate(done, axis=0),),
                               meta={"round": r + 1,
                                     "dropped": self.total_dropped,
                                     "exposed_collective_bytes":
                                         s.exposed_collective_bytes,
                                     "overlap_efficiency":
                                         s.overlap_efficiency,
                                     "graph_version": s.graph_version},
                               blocking=False)
            yield res.walks
            self._drain_updates()
        if self.ckpt is not None:
            self.ckpt.wait()


def elastic_restart(g, cfg: Node2VecConfig, ckpt: Checkpointer,
                    new_mesh=None, device=None) -> WalkRoundRunner:
    """Resume walk rounds on another world (a failure, a rescale): the
    sharded layout is rebuilt for ``new_mesh``'s size inside
    ``WalkEngine.build`` and completed rounds are read back from the
    checkpoint."""
    return WalkRoundRunner(g, cfg, mesh=new_mesh, checkpointer=ckpt,
                           device=device)
