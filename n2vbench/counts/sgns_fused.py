"""Bytes one ``sgns_fused`` launch needs at batch B, K negatives and
dimension D: the (2 + K) float32 rows of every pair read and their
gradients written (8 B D (2 + K)), the center, context and negative ids
and the validity weight (4 B (3 + K)), and the divisor and the loss (8).
Its FLOPs are below its bytes' time at every published peak, so its
roofline is its bytes."""
from __future__ import annotations


def bytes_per_launch(b: int, k: int, d: int) -> int:
    return 8 * b * d * (2 + k) + 4 * b * (3 + k) + 8
