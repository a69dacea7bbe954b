"""``train_stream``: streamed node2vec. A unit walks the next
``walkers_per_round`` starts of a seeded permutation of the vertices
through ``WalkEngine.run`` and hands the walks to
``StreamingSGNSTrainer.consume``; the trainer takes the cell's
``trainer`` arguments as they stand.

Set-up's warm-up round is the trainer's first ``consume``. It is read
twice for the check: step by step through its first steps (see
:class:`FirstSteps`), and whole through the public API, the round's
losses (``loss_history``) and the tables it leaves (``tables``). The
window's rounds are checked by their walks."""
from __future__ import annotations

import math

import numpy as np
import torch

from n2vbench import checks, units
from n2vbench.reference import MASK

SEED_STRIDE = 7919


def pairs_per_walk(length: int, window: int) -> int:
    o = min(window, length - 1)
    return 2 * (o * length - o * (o + 1) // 2)


class FirstSteps:
    """Reads the trainer's first optimizer steps during the warm-up round,
    by a pass-through wrapper of its optimizer that the warm-up removes
    again: the gradients of steps 1 and 2 as the optimizer got them,
    worked out from its state after each (the first moment mu_1 over
    1 - b1, then (mu_2 - b1 mu_1) / (1 - b1)), and the tables as step 4
    gets them (their change over three steps)."""

    def __init__(self, trainer, b1: float):
        from repro_torch.optim.optimizers import Optimizer
        self.trainer = trainer
        self.opt = trainer._opt
        self.b1 = float(b1)
        self.start = {n: t.clone() for n, t in trainer.params.items()}
        self.mu1 = None
        self.calls = 0
        self.grads = {n: [] for n in self.start}
        self.change = {}
        trainer._opt = Optimizer(self.opt.init, self._update, self.opt.key)

    def _norm(self, t) -> float:
        return float(torch.linalg.vector_norm(t, dtype=torch.float64))

    def _update(self, grads, state, params=None):
        self.calls += 1
        if self.calls == 2:
            self.mu1 = {n: m.clone() for n, m in state.mu.items()}
            for n, m in state.mu.items():
                self.grads[n].append(self._norm(m) / (1.0 - self.b1))
        elif self.calls == 3:
            for n, m in state.mu.items():
                g = m.double() - self.b1 * self.mu1[n].double()
                self.grads[n].append(self._norm(g) / (1.0 - self.b1))
            self.mu1 = None
        elif self.calls == 4:
            self.change = {n: self._norm(params[n].double()
                                         - self.start[n].double())
                           for n in params}
            self.start = None
        return self.opt.update(grads, state, params)

    def remove(self) -> None:
        self.trainer._opt = self.opt
        self.start = self.mu1 = None


class Traffic(units.Units):

    def __init__(self, env: units.Env):
        super().__init__(env)
        from repro_torch.train.stream import StreamingSGNSTrainer
        self._order = self.rng.permutation(env.n).astype(np.int32)
        self.trainer = StreamingSGNSTrainer(
            vocab=env.n, seed=env.seeds["train"], device=env.device,
            **env.trainer)
        self.window = int(env.trainer["window"])
        self.batch = int(env.trainer["batch_size"])
        self._next = None
        self.round_walks = []      # the window's rounds' walks
        self.train_steps = 0
        self.first = None          # the warm-up round, read
        self.losses = np.zeros(0)

    def walks(self):
        k = self._index
        self._index += 1
        w = int(self.env.mix["walkers_per_round"])
        at = (k * w) % self.env.n
        starts = np.take(self._order, np.arange(at, at + w), mode="wrap")
        seed = (self.env.seeds["walk"] + SEED_STRIDE * k) & MASK
        return seed, starts, starts, self.env.engine.run(starts,
                                                         seed=seed).walks

    def prepare(self) -> None:
        """Walk the next round ahead of its ``consume``, so that a traced
        window holds the SGNS stage alone."""
        if self._next is None:
            self._next = self.walks()

    def unit(self) -> None:
        self.prepare()
        seed, starts, ids, walks = self._next
        self._next = None
        with torch.profiler.record_function("n2vbench.consume"):
            self.trainer.consume(walks)
        self.keep(seed, starts, ids, walks)
        self.round_walks.append(walks)
        self.train_steps += math.ceil(
            walks.shape[0] * pairs_per_walk(self.length, self.window)
            / self.batch)
        self.units += 1

    def warm_up(self) -> None:
        seed, starts, _, walks = self.walks()
        rec = FirstSteps(self.trainer, self.env.config["adam"]["b1"])
        try:
            self.trainer.consume(walks)
        finally:
            rec.remove()
        self.first = {
            "seed": seed, "starts": starts, "walks": walks,
            "losses": [float(x) for x in self.trainer.loss_history()],
            "grads": rec.grads, "change": rec.change,
            "tables": {n: t.detach().cpu()
                       for n, t in self.trainer.tables().items()}}

    def open_window(self) -> None:
        super().open_window()
        self.round_walks, self.train_steps = [], 0

    def close_window(self) -> None:
        units.sync(self.env.device)

    def attempted(self) -> int:
        return self.train_steps

    def pairs(self) -> int:
        """Valid SGNS pairs of the window's rounds: ordered pairs within
        the window of each walk, a vertex with itself not counted."""
        total = 0
        for walks in self.round_walks:
            length = walks.shape[1]
            for off in range(1, min(self.window, length - 1) + 1):
                total += 2 * int((walks[:, :length - off]
                                  != walks[:, off:]).sum())
        return total

    def rate(self, metric: str, window_s: float):
        if metric.split(".")[0] == "train_pairs_per_s":
            return self.pairs() / window_s
        return None

    def trace_context(self, ctx, units_: int) -> None:
        ctx.walk_units = self.kept
        ctx.train_steps = self.train_steps
        ctx.sgns = {"vocab": self.env.n, "dim": self.env.trainer["dim"],
                    "batch": self.batch,
                    "k": self.env.trainer["negatives"]}

    def release(self) -> None:
        self.losses = self.trainer.loss_history()
        self.trainer = None
        super().release()

    def check(self) -> dict:
        found = super().check()
        found.update(checks.training_against_reference(
            self.env.g, self.env.config, self.env.plan, self.env.trainer,
            self.first, self.env.seeds["train"]))
        found["nonfinite_losses"] = int((~np.isfinite(self.losses)).sum())
        return found

    def failed(self, found: dict) -> int:
        return super().failed(found) + int(found["nonfinite_losses"])
