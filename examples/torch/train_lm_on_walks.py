"""Train an LM architecture of the model zoo on a graph-walk corpus
(DeepWalk-style) — the PyTorch port of ``examples/train_lm_on_walks.py``:
the walk engine is the graph-data pipeline, and any ported arch consumes
it (mamba2 and jamba through the Mamba2 and MoE layers; the
cross-attention archs with zero frames or patches, as the JAX example
feeds them). Uses the reduced (smoke) config. Runs on the card unless
given ``--device cpu``:

    PYTHONPATH=src python examples/torch/train_lm_on_walks.py \\
        --arch mamba2-370m [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.core import rmat
from repro_torch.data.corpus import walks_to_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.launch.train import lm_train_step
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.smoke_config(args.arch)
    graph = rmat.wec(9, avg_degree=15, seed=0)
    walks = WalkEngine.build(graph, WalkPlan(p=1.0, q=0.5, length=64),
                             device=dev).run(seed=0).walks
    tokens = walks_to_lm_tokens(walks % cfg.vocab, seq_len=33)
    print(f"arch={args.arch} corpus={tokens.shape}")

    params = M.init_params(cfg, jr.PRNGKey(0), dev)
    opt = adamw(3e-3)
    opt_state = opt.init(params)

    rng = np.random.default_rng(0)
    extras = M.zero_memory(cfg, 8, dev)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        seqs = torch.from_numpy(tokens[rng.integers(0, tokens.shape[0],
                                                    8)]).to(dev)
        params, opt_state, loss, _ = lm_train_step(
            cfg, opt, params, opt_state,
            {"tokens": seqs[:, :-1], "labels": seqs[:, 1:], **extras})
        losses.append(float(loss))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"({time.time() - t0:.1f}s)")
    print("done")
    return {"tokens": tokens, "losses": losses}


if __name__ == "__main__":
    main()
