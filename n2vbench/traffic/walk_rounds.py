"""``walk_rounds``: FN-Multi rounds of every vertex through
``WalkEngine.rounds``. Round k+1 is enqueued before round k reaches the
host; a unit is one round's arrival. Round k of a walk seeded s draws
under seed s * ROUND_SEED + k (the contract of ``WalkEngine.rounds``)."""
from __future__ import annotations

import numpy as np

from n2vbench import units

ROUND_SEED = 1000003


class Traffic(units.Units):

    def __init__(self, env: units.Env):
        super().__init__(env)
        self._seed = env.seeds["walk"]
        self._rounds = env.engine.rounds(1 << 40, seed=self._seed)
        self._starts = np.arange(env.n, dtype=np.int32)

    def walks(self):
        k = self._index
        self._index += 1
        walks = next(self._rounds).walks
        return self._seed * ROUND_SEED + k, self._starts, self._starts, walks

    def release(self) -> None:
        self._rounds.close()
        self._rounds = None
        super().release()
