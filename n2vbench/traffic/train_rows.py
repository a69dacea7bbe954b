"""``train_rows``: streamed node2vec trained by lazy row-Adam. A unit is a
``train_stream`` unit (the next ``walkers_per_round`` starts of a seeded
permutation, walked by ``WalkEngine.run`` and handed to
``StreamingSGNSTrainer.consume``) with the trainer's ``shard_tables`` on.

Set-up's warm-up round is the trainer's first ``consume``, read whole
through the public API alone: the round's losses (``loss_history``) and
the tables it leaves (``tables``), checked against ``reference_rows.py``
(``checks_rows.py``). The window's rounds are checked by their walks.

The kind keeps the cumulative walk counts of the rounds it hands the
trainer, so that after a traced window it can replay the traced rounds'
ids with the reference's functions: the rows their steps name
(``ctx.rows``), counted by the benchmark and not by the program's padded
buffers."""
from __future__ import annotations

import numpy as np
import torch

from n2vbench import checks_rows, reference_rows, units
from n2vbench.traffic import train_stream


class Traffic(train_stream.Traffic):

    def __init__(self, env: units.Env):
        if not env.trainer.get("shard_tables"):
            raise ValueError("train_rows needs a trainer with shard_tables")
        super().__init__(env)
        self.counts = np.zeros(env.n, np.float64)
        self.rounds = 0            # rounds handed to the trainer
        self.traced = []           # (round index, walks, counts) if traced

    def _consume(self, walks: np.ndarray) -> None:
        self.counts += np.bincount(walks.reshape(-1), minlength=self.env.n)
        if self.keep_all:
            self.traced.append((self.rounds, walks, self.counts.copy()))
        self.rounds += 1

    def unit(self) -> None:
        self.prepare()
        self._consume(self._next[3])
        super().unit()

    def warm_up(self) -> None:
        seed, starts, _, walks = self.walks()
        self._consume(walks)
        self.trainer.consume(walks)
        self.first = {
            "seed": seed, "starts": starts, "walks": walks,
            "losses": [float(x) for x in self.trainer.loss_history()],
            "tables": {n: t.detach().cpu()
                       for n, t in self.trainer.tables().items()}}

    def trace_context(self, ctx, units_: int) -> None:
        super().trace_context(ctx, units_)
        cfg = checks_rows.rows_config(self.env.g, self.env.config,
                                      self.env.trainer)
        rows = {"distinct": 0, "steps": 0}
        for index, walks, counts in self.traced:
            walk = torch.from_numpy(walks.astype(np.int64)).to(
                self.env.device)
            got = reference_rows.distinct_rows(
                walk, cfg, self.env.seeds["train"], index, counts)
            for k in rows:
                rows[k] += got[k]
        ctx.rows = rows
        self.traced = []

    def check(self) -> dict:
        found = units.Units.check(self)
        found.update(checks_rows.training_against_reference(
            self.env.g, self.env.config, self.env.plan, self.env.trainer,
            self.first, self.env.seeds["train"]))
        found["nonfinite_losses"] = int((~np.isfinite(self.losses)).sum())
        return found
