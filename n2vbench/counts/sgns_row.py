"""Bytes one launch of ``sgns_fused``'s row entry needs at batch B, K
negatives and dimension D: the (2 + K) gathered float32 rows of every
pair read and their gradients written (8 B D (2 + K)), the validity
weight (4 B) and the loss sum (4). The rows come gathered, so no id is
read, and the entry divides by nothing. Its FLOPs are below its bytes'
time at every published peak, so its roofline is its bytes."""
from __future__ import annotations


def bytes_per_launch(b: int, k: int, d: int) -> int:
    return 8 * b * d * (2 + k) + 4 * b + 4
