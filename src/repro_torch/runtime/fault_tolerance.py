"""Fault tolerance for the walk rounds — port of
``repro.runtime.fault_tolerance`` for one device.

FN-Multi rounds (the paper's k independent rounds, §3.4) are the fault
boundary: each completed round is checkpointed atomically, and a crashed
run resumes from the first incomplete round. Walker state is keyed by
vertex id and the RNG by (seed, round, walker, step), so resumed rounds
equal uninterrupted ones bit for bit. Edge deltas submitted mid-stream
land between rounds (:meth:`WalkRoundRunner.submit_update`).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

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
    ``device="cpu"``. Per-round :class:`WalkStats` are kept in
    ``round_stats``.
    """

    def __init__(self, g, cfg: Node2VecConfig,
                 checkpointer: Optional[Checkpointer] = None, device=None):
        self.g = g
        self.cfg = cfg
        self.ckpt = checkpointer
        self.engine = WalkEngine.build(g, cfg.plan(), device=device)
        self.round_stats: dict = {}        # round -> WalkStats (this process)
        self._pending_updates: list = []   # DeltaBatches queued mid-stream
        self.update_reports: list = []     # UpdateReport per drained queue

    def completed_rounds(self) -> int:
        if self.ckpt is None:
            return 0
        step = self.ckpt.latest_step()
        return 0 if step is None else step

    def run_round(self, r: int) -> np.ndarray:
        res = self.engine.run(seed=round_seed(self.cfg.seed, r))
        self.round_stats[r] = res.stats
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
        """The JAX package's cumulative accounting: on one device no
        request is dropped and no collective bytes move."""
        return {"dropped": 0,
                "exposed_collective_bytes": 0,
                "collective_bytes": 0,
                "overlap_efficiency": 0.0}

    def rounds(self) -> Iterator[np.ndarray]:
        n = self.engine.n
        start = self.completed_rounds()
        done = []
        if start and self.ckpt is not None:
            (prev,), _ = self.ckpt.restore((np.zeros(
                (start * n, self.cfg.walk_length), np.int32),))
            done = [prev[i * n:(i + 1) * n] for i in range(start)]
            for w in done:
                yield w
        # engine.rounds enqueues round r+1 before round r is copied to the
        # host, with the same per-round seeds as run_round(r)
        live = self.engine.rounds(self.cfg.num_walks, seed=self.cfg.seed,
                                  start=start)
        for r, res in zip(range(start, self.cfg.num_walks), live):
            self.round_stats[r] = res.stats
            done.append(res.walks)
            if self.ckpt is not None:
                self.ckpt.save(r + 1, (np.concatenate(done, axis=0),),
                               meta={"round": r + 1,
                                     "graph_version":
                                         res.stats.graph_version},
                               blocking=False)
            yield res.walks
            self._drain_updates()
        if self.ckpt is not None:
            self.ckpt.wait()


def elastic_restart(g, cfg: Node2VecConfig, ckpt: Checkpointer,
                    device=None) -> WalkRoundRunner:
    """Resume walk rounds in a new process (after a failure or on another
    card): the layout is rebuilt and completed rounds are read back from
    the checkpoint."""
    return WalkRoundRunner(g, cfg, checkpointer=ckpt, device=device)
