"""Bytes one ``node2vec_step`` launch needs: one exact second-order draw
for every walker at one superstep, with no row carried between launches.

Per walker it reads v's live row, ids and weights (8 bytes a lane), and
u's live row, ids only (4 bytes a lane), once each; the walker's u, v
and uniform (12 bytes) and the two row extents (8 bytes); and it writes
the slot and the next vertex (8 bytes). Lanes past a row's degree are not
counted: no draw needs them.
"""
from __future__ import annotations

import numpy as np

PER_WALKER = 12 + 8 + 8


def bytes_per_launch(deg: np.ndarray, starts: np.ndarray,
                     walks: np.ndarray) -> float:
    """Mean bytes a launch over the supersteps 1..L-1 of ``walks`` [W, L]
    (column 0 the first sampled step) started at ``starts`` [W]."""
    w, length = walks.shape
    if length < 2:
        return 0.0
    d = deg.astype(np.int64)
    total = 0
    u = starts
    for s in range(1, length):
        v = walks[:, s - 1]
        total += 8 * int(d[v].sum()) + 4 * int(d[u].sum())
        u = v
    return total / (length - 1) + PER_WALKER * w
