"""The work one dense-Adam SGNS step needs over two [V, D] float32 tables
at batch B, K negatives.

Bytes: dense Adam moves every element of both tables every step, so each
table, its first and its second moment are read and written once (48 V D
for the two tables); the (2 + K) rows of every pair are gathered and
their gradients produced once (8 B D (2 + K)); the ids and the validity
weight are read once (4 B (3 + K)).

FLOPs: per pair 1 + K dot products of D and their gradients, 6 D (1 + K);
per table element Adam's 14 (two moment updates, the two bias
corrections, the square root, the division and the step).
"""
from __future__ import annotations

ADAM_FLOPS = 14


def bytes_per_step(v: int, d: int, b: int, k: int) -> int:
    return 48 * v * d + 8 * b * d * (2 + k) + 4 * b * (3 + k)


def flops_per_step(v: int, d: int, b: int, k: int) -> int:
    return 6 * b * d * (1 + k) + ADAM_FLOPS * 2 * v * d
