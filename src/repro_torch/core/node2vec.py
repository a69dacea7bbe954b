"""End-to-end Node2Vec pipeline: graph -> walks -> SGNS embeddings — port
of ``repro.core.node2vec``.

The walk stage runs ``num_walks`` FN-Multi rounds through
``repro_torch.engine.WalkEngine``; :meth:`Node2VecConfig.plan` derives the
``WalkPlan``. :func:`train_embeddings` trains on host batches
(``walks_to_sgns_batches``) through ``train_step`` on its default
``"jnp"`` backend, as the JAX package does: ``sgns_backend`` takes effect
only in the streamed trainer (``repro_torch.train.stream``). Entry points
run on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.skipgram import (SGNSConfig, init_params,
                                       normalize_embeddings, train_step)
from repro_torch.data.corpus import walks_to_sgns_batches
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.optim.optimizers import adam


@dataclasses.dataclass
class Node2VecConfig:
    p: float = 1.0
    q: float = 1.0
    walk_length: int = 80
    num_walks: int = 10           # r: rounds of walks per vertex (FN-Multi)
    window: int = 10
    dim: int = 128
    negatives: int = 5
    epochs: int = 1
    batch_size: int = 1024
    lr: float = 0.025
    mode: str = "exact"           # exact | approx | approx_always
    approx_eps: float = 1e-3
    sgns_backend: str = "jnp"     # streamed trainer's gradient backend
    cap: Optional[int] = None     # cold row width (None -> FN-Base layout)
    seed: int = 0
    backend: Optional[str] = None  # None -> reference; "sharded" raises
    pipeline: bool = False         # whole-walk kernel where it applies

    def plan(self) -> WalkPlan:
        """The walk-stage half of this config as a ``WalkPlan``."""
        return WalkPlan(p=self.p, q=self.q, length=self.walk_length,
                        mode=self.mode, approx_eps=self.approx_eps,
                        backend=self.backend or "reference", cap=self.cap,
                        pipeline=self.pipeline)


def generate_walks(g, cfg: Node2VecConfig, device=None) -> np.ndarray:
    """All rounds of walks, [r * n, walk_length]."""
    engine = WalkEngine.build(g, cfg.plan(), device=device)
    return np.concatenate([res.walks for res in
                           engine.rounds(cfg.num_walks, seed=cfg.seed)],
                          axis=0)


def train_embeddings(g, walks: np.ndarray, cfg: Node2VecConfig,
                     device=None) -> np.ndarray:
    """SGNS over the walk corpus; returns L2-normalized [n, dim]
    embeddings."""
    dev = resolve_device(device)
    scfg = SGNSConfig(vocab=g.n, dim=cfg.dim, negatives=cfg.negatives)
    params = init_params(scfg, jr.PRNGKey(cfg.seed, device=dev))
    opt = adam(cfg.lr)
    opt_state = opt.init(params)
    for batch in walks_to_sgns_batches(walks, g.n, cfg.window, cfg.negatives,
                                       cfg.batch_size, seed=cfg.seed,
                                       epochs=cfg.epochs):
        tbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, _ = train_step(params, opt_state, tbatch, opt)
    return normalize_embeddings(params).cpu().numpy()


def node2vec(g, cfg: Node2VecConfig, device=None) -> np.ndarray:
    walks = generate_walks(g, cfg, device=device)
    return train_embeddings(g, walks, cfg, device=device)
