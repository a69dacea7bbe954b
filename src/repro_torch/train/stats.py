"""TrainStats — the streaming trainer's structured diagnostics — port of
``repro.train.stats``, unchanged in behaviour.

The walk engine reports what one *run* did and the serving layer what a
*traffic window* did; the trainer reports what one *streamed training run*
did: throughput (pairs/sec, tokens/sec), how much walk time hid behind
training (overlap efficiency), and how many bytes crossed the host→device
boundary versus what the per-batch host-staging path would have uploaded.

``TrainRecorder`` is the mutable accumulator the trainer feeds per round;
:meth:`TrainRecorder.snapshot` freezes it into a :class:`TrainStats`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainStats:
    """Frozen per-run streaming-training diagnostics.

    ``backend``            — SGNS gradient backend (``jnp`` | ``fused``).
    ``rounds`` / ``steps`` — FN-Multi rounds consumed / optimizer steps run.
    ``pairs``              — valid (center, context) pairs trained on
                             (self-pairs and batch padding are masked out and
                             not counted).
    ``tokens``             — corpus tokens consumed (walkers × length,
                             summed over rounds).
    ``walk_wait_seconds``  — host time blocked waiting on the walk source
                             (the *exposed* walk time; dispatched-ahead
                             rounds that finished behind training cost ~0).
    ``train_seconds``      — host time driving/finalizing training steps.
    ``wall_seconds``       — end-to-end duration of :meth:`~repro_torch.
                             train.stream.StreamingSGNSTrainer.train`.
    ``overlap_efficiency`` — estimated fraction of post-round-0 walk time
                             hidden behind training: round 0 is always fully
                             exposed (nothing to overlap with), so its wait
                             estimates the per-round walk cost c, and
                             efficiency = 1 − Σ wait[1:] / (c·(R−1)),
                             clipped to [0, 1]; 0.0 when R < 2. An estimate
                             (load noise moves c), reported for telemetry —
                             benches gate on the stream/concat wall-clock
                             ratio instead.
    ``pairs_per_sec`` / ``tokens_per_sec`` — throughput over wall time.
    ``h2d_bytes``          — actual host→device uploads: each round's walks
                             once, plus the per-round alias refresh.
    ``h2d_bytes_concat``   — what per-step host batch staging (the old
                             ``walks_to_sgns_batches`` path) would have
                             uploaded for the same steps: exact, so the
                             stream/concat H2D ratio is deterministic.
    ``shards``             — table shards (1 = dense single-device tables).
    ``collective_bytes``   — analytic per-device bytes the sparse row
                             gathers/updates moved across the mesh. Always
                             0 here: the port's tables are dense on one
                             device (sharding is ROADMAP.md Queue 1 item 9);
                             the field keeps the JAX package's stats shape.
    ``exposed_collective_bytes`` — the part on the critical path. The
                             sparse gather is barrier-style inside each
                             step today, so exposed == total; the field
                             exists (mirroring ``WalkStats``) so a future
                             double-buffered exchange shows up as a drop.
    ``collective_overlap_efficiency`` — ``1 − exposed/total`` (0 when
                             nothing is on the wire).
    """
    backend: str
    rounds: int = 0
    steps: int = 0
    pairs: int = 0
    tokens: int = 0
    walk_wait_seconds: float = 0.0
    train_seconds: float = 0.0
    wall_seconds: float = 0.0
    overlap_efficiency: float = 0.0
    pairs_per_sec: float = 0.0
    tokens_per_sec: float = 0.0
    h2d_bytes: int = 0
    h2d_bytes_concat: int = 0
    shards: int = 1
    collective_bytes: int = 0
    exposed_collective_bytes: int = 0
    collective_overlap_efficiency: float = 0.0


class TrainRecorder:
    """Mutable accumulator behind :class:`TrainStats`."""

    def __init__(self, backend: str, shards: int = 1) -> None:
        self.backend = backend
        self.shards = shards
        self._waits: list[float] = []
        self._train_s = 0.0
        self.rounds = 0
        self.steps = 0
        self.pairs = 0
        self.tokens = 0
        self.h2d_bytes = 0
        self.h2d_bytes_concat = 0
        self.collective_bytes = 0
        self.exposed_collective_bytes = 0

    # ------------------------------------------------------------ events --
    def walk_waited(self, seconds: float) -> None:
        self._waits.append(seconds)

    def round_trained(self, seconds: float, steps: int, pairs: int,
                      tokens: int, h2d_bytes: int, h2d_bytes_concat: int,
                      collective_bytes: int = 0,
                      exposed_collective_bytes: int | None = None) -> None:
        self._train_s += seconds
        self.rounds += 1
        self.steps += steps
        self.pairs += pairs
        self.tokens += tokens
        self.h2d_bytes += h2d_bytes
        self.h2d_bytes_concat += h2d_bytes_concat
        self.collective_bytes += collective_bytes
        # barrier-style sparse gathers: exposed == total unless told better
        self.exposed_collective_bytes += (
            collective_bytes if exposed_collective_bytes is None
            else exposed_collective_bytes)

    def finalized(self, seconds: float) -> None:
        """Terminal block (flushing the async step queue + fetching params)
        counts as training time."""
        self._train_s += seconds

    # ---------------------------------------------------------- snapshot --
    def overlap_efficiency(self) -> float:
        if len(self._waits) < 2:
            return 0.0
        per_round = self._waits[0]
        if per_round <= 0.0:
            return 0.0
        exposed = sum(self._waits[1:])
        eff = 1.0 - exposed / (per_round * (len(self._waits) - 1))
        return min(max(eff, 0.0), 1.0)

    def snapshot(self, wall_seconds: float) -> TrainStats:
        wall = max(wall_seconds, 1e-12)
        return TrainStats(
            backend=self.backend,
            rounds=self.rounds,
            steps=self.steps,
            pairs=self.pairs,
            tokens=self.tokens,
            walk_wait_seconds=sum(self._waits),
            train_seconds=self._train_s,
            wall_seconds=wall_seconds,
            overlap_efficiency=self.overlap_efficiency(),
            pairs_per_sec=self.pairs / wall,
            tokens_per_sec=self.tokens / wall,
            h2d_bytes=self.h2d_bytes,
            h2d_bytes_concat=self.h2d_bytes_concat,
            shards=self.shards,
            collective_bytes=self.collective_bytes,
            exposed_collective_bytes=self.exposed_collective_bytes,
            collective_overlap_efficiency=(
                1.0 - self.exposed_collective_bytes / self.collective_bytes
                if self.collective_bytes else 0.0),
        )
