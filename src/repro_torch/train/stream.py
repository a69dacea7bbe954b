"""StreamingSGNSTrainer — train SGNS on each FN-Multi round as it arrives —
port of ``repro.train.stream`` (dense tables).

The corpus never exists on the host:

* each round's walks upload to the device once (plus a [V]-sized alias
  refresh); pairs are window-offset gathers over the resident walks
  (``repro_torch.train.pairs``);
* negatives are O(1) device alias draws from the cumulative unigram^0.75
  counts (rounds 0..k when training round k);
* an epoch over a round is a Python loop over the fixed ``[steps, batch]``
  permutation grid (the JAX package's ``lax.scan``): per step a
  permutation-row gather, alias negatives, and an SGNS update;
* ``sgns_backend="fused"`` runs the fused SGNS kernel
  (``repro_torch.core.skipgram.sgns_grads``).

Streamed and concat consumption are bit-identical: every batch depends only
on (round index, epoch, step index) and the cumulative corpus counts up to
that round, never on arrival timing, and on the card every scatter is
deterministic. ``shard_tables=True`` (the JAX package's mesh-partitioned
tables) is ROADMAP.md Queue 1 item 9 and raises here.
"""
from __future__ import annotations

import math
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.alias import build_alias
from repro_torch.core.skipgram import (SGNSConfig, init_params,
                                       normalize_embeddings, sgns_grads)
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.train.pairs import device_negatives, device_pairs, num_pairs
from repro_torch.train.stats import TrainRecorder, TrainStats


def _gen_pairs(walks: torch.Tensor, window: int):
    """Resident walks -> pair arrays, per-pair validity, valid count."""
    c, x, valid = device_pairs(walks, window)
    return c, x, valid, valid.sum()


def _perm_batches(key: torch.Tensor, n: int, steps: int,
                  batch: int) -> torch.Tensor:
    """Device shuffle of ``n`` pair slots, padded with slot 0 to the fixed
    step grid and reshaped [steps, batch] (pad slots are masked by their
    position in the step)."""
    perm = jr.permutation(key, n)
    pad = torch.zeros(steps * batch - n, dtype=perm.dtype,
                      device=perm.device)
    return torch.cat([perm, pad]).reshape(steps, batch)


def _train_epoch(params, opt_state, c, x, valid, perm2d, prob, alias, key,
                 *, opt, negatives, backend, n_pairs):
    """One epoch over one round: per row of the [steps, batch] permutation
    grid, a gather of pairs, alias negatives and one SGNS update. Returns
    (params, opt_state, per-step losses [steps])."""
    steps, batch_size = perm2d.shape
    lane = torch.arange(batch_size, device=perm2d.device)
    losses = []
    for s in range(steps):
        idx = perm2d[s]
        in_bounds = (s * batch_size + lane) < n_pairs
        batch = {
            "center": c[idx],
            "pos": x[idx],
            "neg": device_negatives(jr.fold_in(key, s), prob, alias,
                                    (batch_size, negatives)),
            "valid": (valid[idx] & in_bounds).to(torch.float32),
        }
        loss, grads = sgns_grads(params, batch, backend)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    return params, opt_state, torch.stack(losses)


class StreamingSGNSTrainer:
    """Consume per-round walk arrays as they complete; keep all corpus work
    on the device. One instance is one training run (params live across
    rounds). Runs on the card unless given ``device="cpu"``."""

    def __init__(self, vocab: int, dim: int = 128, window: int = 10,
                 negatives: int = 5, batch_size: int = 1024,
                 lr: float = 0.025, epochs: int = 1, seed: int = 0,
                 sgns_backend: str = "jnp", power: float = 0.75,
                 record_loss: bool = True, shard_tables: bool = False,
                 device=None):
        if shard_tables:
            raise NotImplementedError(
                "shard_tables=True is not ported yet: it is ROADMAP.md "
                "Queue 1 item 9 (Multi-device, torch.distributed)")
        self.device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.window = window
        self.negatives = negatives
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.sgns_backend = sgns_backend
        self.power = power
        self.record_loss = record_loss
        scfg = SGNSConfig(vocab=vocab, dim=dim, negatives=negatives)
        self._key = jr.PRNGKey(seed, device=self.device)
        self.params = init_params(scfg, self._key)
        self._opt = adam(lr)
        self.opt_state = self._opt.init(self.params)
        self._counts = np.zeros(vocab, np.float64)
        self._round = 0
        self._losses: list = []        # device tensors; fetched lazily
        self._pair_counts: list = []   # device scalars (valid pairs / round)
        self.recorder = TrainRecorder(sgns_backend)

    @classmethod
    def from_config(cls, vocab: int, cfg, **overrides
                    ) -> "StreamingSGNSTrainer":
        """Build from the SGNS half of a ``Node2VecConfig``-shaped object."""
        kw = dict(dim=cfg.dim, window=cfg.window, negatives=cfg.negatives,
                  batch_size=cfg.batch_size, lr=cfg.lr, epochs=cfg.epochs,
                  seed=cfg.seed,
                  sgns_backend=getattr(cfg, "sgns_backend", "jnp"))
        kw.update(overrides)
        return cls(vocab, **kw)

    # ---------------------------------------------------------- one round --
    def _alias_refresh(self, walks: np.ndarray):
        """Fold the round into the cumulative unigram counts and rebuild the
        [V] negative-sampling alias table (O(V) host, uploaded once)."""
        self._counts += np.bincount(walks.reshape(-1), minlength=self.vocab)
        freq = self._counts ** self.power
        if freq.sum() == 0:
            freq = np.ones(self.vocab)
        prob_np, alias_np = build_alias(freq)
        return (torch.from_numpy(prob_np).to(self.device),
                torch.from_numpy(alias_np).to(self.device),
                prob_np.nbytes + alias_np.nbytes)

    def consume(self, walks: np.ndarray) -> None:
        """Train ``epochs`` passes over one round."""
        t0 = time.perf_counter()
        walks = np.ascontiguousarray(walks, np.int32)
        w, l = walks.shape
        n_pairs = num_pairs(w, l, self.window)
        prob, alias, alias_bytes = self._alias_refresh(walks)
        if n_pairs == 0:
            self._round += 1
            self.recorder.round_trained(time.perf_counter() - t0, 0, 0,
                                        w * l, walks.nbytes + alias_bytes, 0)
            return
        dev_walks = torch.from_numpy(walks).to(self.device)
        c, x, valid, n_valid = _gen_pairs(dev_walks, self.window)
        self._pair_counts.append(n_valid * self.epochs)
        steps = math.ceil(n_pairs / self.batch_size)
        rkey = jr.fold_in(self._key, self._round)
        for e in range(self.epochs):
            pkey, skey = jr.split(jr.fold_in(rkey, e))
            perm2d = _perm_batches(pkey, n_pairs, steps, self.batch_size)
            self.params, self.opt_state, losses = _train_epoch(
                self.params, self.opt_state, c, x, valid, perm2d, prob,
                alias, skey, opt=self._opt, negatives=self.negatives,
                backend=self.sgns_backend, n_pairs=n_pairs)
            if self.record_loss:
                self._losses.append(losses)
        self._round += 1
        # concat-equivalent H2D: the host path stages center/pos/neg (i32)
        # + valid (f32) per step; deterministic, so the ratio is exact
        per_step = 4 * self.batch_size * (3 + self.negatives)
        self.recorder.round_trained(
            time.perf_counter() - t0, steps * self.epochs, 0, w * l,
            walks.nbytes + alias_bytes, steps * self.epochs * per_step)

    # --------------------------------------------------------- training --
    def train(self, source: Iterable[np.ndarray],
              max_rounds: Optional[int] = None
              ) -> Tuple[np.ndarray, TrainStats]:
        """Drive training over ``source`` (an iterator of per-round ``[W, L]``
        walk arrays, e.g. ``WalkRoundRunner.rounds()``). Returns
        (L2-normalized [V, dim] embeddings, :class:`TrainStats`)."""
        t_start = time.perf_counter()
        it = iter(source)
        seen = 0
        while max_rounds is None or seen < max_rounds:
            t0 = time.perf_counter()
            try:
                walks = next(it)
            except StopIteration:
                break
            self.recorder.walk_waited(time.perf_counter() - t0)
            self.consume(np.asarray(walks))
            seen += 1
        return self.finish(time.perf_counter() - t_start)

    def finish(self, wall_seconds: Optional[float] = None
               ) -> Tuple[np.ndarray, TrainStats]:
        """Wait for the queued steps, fetch embeddings, freeze stats."""
        t0 = time.perf_counter()
        emb = normalize_embeddings(self.params).cpu().numpy()
        if self._pair_counts:
            self.recorder.pairs = int(sum(int(p) for p in self._pair_counts))
            self._pair_counts = [torch.tensor(self.recorder.pairs)]
        self.recorder.finalized(time.perf_counter() - t0)
        if wall_seconds is None:   # consume() called directly, not train()
            wall_seconds = sum(self.recorder._waits) + self.recorder._train_s
        return emb, self.recorder.snapshot(wall_seconds)

    def loss_history(self) -> np.ndarray:
        """Per-step losses, concatenated over epochs and rounds."""
        if not self._losses:
            return np.zeros(0, np.float32)
        return torch.cat(self._losses).cpu().numpy()


def train_streamed(g, cfg, checkpointer=None, device=None, **overrides
                   ) -> Tuple[np.ndarray, TrainStats]:
    """End-to-end streamed node2vec stage 2: walk rounds through a
    :class:`~repro_torch.runtime.fault_tolerance.WalkRoundRunner`
    (checkpointed when given a checkpointer) feeding a
    :class:`StreamingSGNSTrainer`. Same round seeds as ``node2vec``, so a
    concat replay of the same config reproduces it bit for bit."""
    from repro_torch.runtime.fault_tolerance import WalkRoundRunner
    runner = WalkRoundRunner(g, cfg, checkpointer=checkpointer,
                             device=device)
    trainer = StreamingSGNSTrainer.from_config(runner.engine.n, cfg,
                                               device=device, **overrides)
    return trainer.train(runner.rounds())
