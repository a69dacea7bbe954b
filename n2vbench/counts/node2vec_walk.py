"""Bytes one ``node2vec_walk`` launch needs: supersteps 1..L-1 of every
walker's exact walk in one launch, each row read once.

Per walker it reads the start's live row of ids (4 bytes a lane), the
start and the first step (8 bytes), and at every superstep v's live row,
ids and weights (8 bytes a lane; it is the next superstep's u row, so it
is not counted twice), the superstep's uniform (4 bytes) and the row's
extent (8 bytes), and writes the next vertex (4 bytes).
"""
from __future__ import annotations

import numpy as np

PER_WALKER = 8
PER_STEP = 4 + 8 + 4


def bytes_per_launch(deg: np.ndarray, starts: np.ndarray,
                     walks: np.ndarray) -> float:
    """Bytes of the launch that walked ``walks`` [W, L] (column 0 the
    first sampled step) from ``starts`` [W]."""
    w, length = walks.shape
    if length < 2:
        return 0.0
    d = deg.astype(np.int64)
    rows = 4 * int(d[starts].sum()) + \
        8 * int(d[walks[:, :length - 1]].sum())
    return rows + w * (PER_WALKER + PER_STEP * (length - 1))
