"""The work one lazy row-Adam SGNS step needs at batch B, K negatives and
dimension D, when it names ``distinct`` rows in all (the distinct centre
rows plus the distinct context and negative rows; the benchmark counts
them by replaying the step's ids, ``reference_rows.distinct_rows``).

Bytes: the (2 + K) rows of every pair are gathered and their gradients
produced once (8 B D (2 + K)); the ids and the validity weight are read
once (4 B (3 + K)); each named row's table entry, two moments and
gradient are read and its table entry and two moments written once
(28 D a named row).

FLOPs: per pair 1 + K dot products of D and their gradients, 6 D (1 + K);
per named row element Adam's 14 (two moment updates, the two bias
corrections, the square root, the division and the step).
"""
from __future__ import annotations

ADAM_FLOPS = 14


def bytes_per_step(distinct: float, d: int, b: int, k: int) -> float:
    return 8 * b * d * (2 + k) + 4 * b * (3 + k) + 28 * d * distinct


def flops_per_step(distinct: float, d: int, b: int, k: int) -> float:
    return 6 * b * d * (1 + k) + ADAM_FLOPS * d * distinct
