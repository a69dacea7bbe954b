"""What every traffic kind shares.

A traffic kind is a file ``traffic/<kind>.py`` that defines ``Traffic``, a
subclass of :class:`Units`; a mix file names its kind and holds its
parameters. The harness drives it the same way for every kind: set-up
calls :meth:`Units.warm_up`, the window calls :meth:`Units.unit` until its
time is up, :meth:`Units.rate` gives the window's end-to-end metrics,
:meth:`Units.release` lets go of the program's state, and
:meth:`Units.check` compares what the window produced with the reference.
Adding a kind adds a file; it edits none.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from n2vbench import checks
from n2vbench.reference import MASK


@dataclasses.dataclass
class Env:
    """What a traffic kind is handed: the built engine, the cell's files
    and the run's seeds."""
    engine: object           # repro_torch.engine.WalkEngine
    g: object                # graphs.CSR, also the reference's input
    config: dict             # the configuration's file
    plan: dict               # WalkPlan's arguments (config, then mix)
    trainer: dict            # StreamingSGNSTrainer's (config, then mix)
    mix: dict
    seeds: dict              # graph, walk, train, sample
    device: torch.device

    @property
    def n(self) -> int:
        return self.g.n


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Units:
    """Walk units: each yields walks that reach the host. A unit keeps the
    mix's ``check_walkers`` of its walks, drawn from the seed, for the
    check, and all of them while traced (for the counts)."""

    def __init__(self, env: Env):
        self.env = env
        self.length = int(env.plan["length"])
        self.rng = np.random.default_rng(env.seeds["sample"])
        self.samples = []          # (seeds, starts, walker ids, walks)
        self.kept = []             # (starts, walks) of traced units
        self.keep_all = False
        self.units = 0             # units since the window opened
        self.walker_steps = 0
        self._index = 0

    # a kind's own ------------------------------------------------------
    def walks(self):
        """The next unit's walks: (seed, starts, walker ids, walks)."""
        raise NotImplementedError

    # the harness's calls -------------------------------------------------
    def keep(self, seed: int, starts, ids, walks: np.ndarray) -> None:
        m = min(int(self.env.mix["check_walkers"]), walks.shape[0])
        pick = np.sort(self.rng.choice(walks.shape[0], m, replace=False))
        self.samples.append((np.full(m, seed & MASK, np.int64),
                             np.asarray(starts)[pick].astype(np.int64),
                             np.asarray(ids)[pick].astype(np.int64),
                             walks[pick].copy()))
        if self.keep_all:
            self.kept.append((np.asarray(starts), walks))

    def unit(self) -> None:
        seed, starts, ids, walks = self.walks()
        self.keep(seed, starts, ids, walks)
        self.walker_steps += walks.size
        self.units += 1

    def warm_up(self) -> None:
        """One unit at the cell's own shapes."""
        self.unit()

    def prepare(self) -> None:
        """Work of the next unit that a traced window leaves out."""

    def open_window(self) -> None:
        self.units = self.walker_steps = 0
        self.samples, self.kept = [], []

    def close_window(self) -> None:
        """The end of the window's time: walks are on the host already."""

    def attempted(self) -> int:
        return self.walker_steps // self.length

    def rate(self, metric: str, window_s: float):
        """The window's end-to-end metric ``metric`` (a name, or a name
        with a suffix after a dot), None if this kind cannot count it."""
        if metric.split(".")[0] == "walk_steps_per_s":
            return self.walker_steps / window_s
        return None

    def trace_context(self, ctx, units: int) -> None:
        """What the per-layer readers read of ``units`` traced units."""
        ctx.walk_units = self.kept
        ctx.supersteps = units * self.length

    def release(self) -> None:
        """Let go of the program's state before the reference runs."""
        self.env.engine = None
        sync(self.env.device)

    def check(self) -> dict:
        """The compared numbers (``checks.py``) of what the window made."""
        return checks.walks_against_reference(self.env.g, self.env.plan,
                                              self.samples)

    def failed(self, found: dict) -> int:
        return int(found.get("walks_wrong", 0))
