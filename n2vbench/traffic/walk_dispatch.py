"""``walk_dispatch``: ``walks_per_vertex`` walks of every vertex in one
``WalkEngine.run`` (walker ids 0..r n - 1), a fresh seed a dispatch; a
unit is one dispatch. ``start_order`` is ``tile`` (the vertices in order,
r times over: the default) or ``repeat`` (each vertex r times in a row,
so that the starts are grouped by the shard that owns them)."""
from __future__ import annotations

import numpy as np

from n2vbench import units
from n2vbench.reference import MASK

SEED_STRIDE = 7919


class Traffic(units.Units):

    def __init__(self, env: units.Env):
        super().__init__(env)
        r = int(env.mix["walks_per_vertex"])
        order = env.mix.get("start_order", "tile")
        base = np.arange(env.n, dtype=np.int32)
        if order == "tile":
            self._starts = np.tile(base, r)
        elif order == "repeat":
            self._starts = np.repeat(base, r)
        else:
            raise ValueError(f"start_order {order!r}: tile or repeat")
        self._ids = np.arange(r * env.n, dtype=np.int32)

    def walks(self):
        k = self._index
        self._index += 1
        seed = (self.env.seeds["walk"] + SEED_STRIDE * k) & MASK
        walks = self.env.engine.run(self._starts, seed=seed,
                                    walker_ids=self._ids).walks
        return seed, self._starts, self._ids, walks
