"""The comparisons that decide ``correct``: what the timed path produced
against what ``reference.py`` works out from the same graph and seeds.

* Walks: every sampled walk of the window, walker-step by walker-step,
  against the reference's walk of the same walker, seed and start. The
  number compared is the share of walker-steps that differ; the limit is
  0, the comparison exact.
* Training: the trainer's first round (set-up's warm-up round) against
  the reference's float64 round on the same walks. Step by step: the
  losses of steps 1-3, the gradients' norms of steps 1 and 2 by leaf,
  and the tables' change over three steps by leaf. Whole: the round's
  losses, and the tables' change over the round by leaf (the tables as
  ``tables()`` gives them, less the reference's initial tables). Losses
  are compared as |loss - ref| / ref at the worst step; norms as the gap
  between the program's norm and the reference's over the larger of the
  reference's norm of that leaf and of the median leaf. A leaf whose
  reference gradient stays under a thousandth of the median leaf's over
  the steps read moves by round-off alone under Adam and is left out of
  the changes.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from n2vbench import reference

CHUNK = 8192
QUIET = 1e-3


def sampled_walks(g, plan: dict, samples, dtype=torch.float32):
    """The reference's walks of the sampled walkers, [S, L] int64 on the
    host, in the order of ``samples`` (seeds, starts, ids, walks). The
    reference walks the exact mode alone: a plan in another mode needs a
    reference of its own."""
    if plan.get("mode", "exact") != "exact":
        raise ValueError(f"the reference walks the exact mode, not "
                         f"{plan['mode']!r}")
    seeds = np.concatenate([s[0] for s in samples])
    starts = np.concatenate([s[1] for s in samples])
    ids = np.concatenate([s[2] for s in samples])
    out = []
    for lo in range(0, len(seeds), CHUNK):
        hi = lo + CHUNK
        out.append(reference.walks(
            g.row_ptr, g.col, g.wgt, starts[lo:hi], ids[lo:hi],
            seeds[lo:hi], int(plan["length"]), plan["p"], plan["q"],
            dtype).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, plan["length"]))


def walk_gaps(got: np.ndarray, want: np.ndarray) -> dict:
    diff = got.astype(np.int64) != want
    return {"walk_mismatch": float(diff.mean()) if diff.size else 0.0,
            "walks_wrong": int(diff.any(axis=1).sum())}


def walks_against_reference(g, plan: dict, samples,
                            dtype=torch.float32) -> dict:
    if not samples:
        return {"walk_mismatch": 1.0, "walks_wrong": 0}
    got = np.concatenate([s[3] for s in samples])
    return walk_gaps(got, sampled_walks(g, plan, samples, dtype))


def _rel(a: float, b: float, scale: float) -> float:
    """|a - b| over ``scale``; 1 where the scale is 0 and a != b, and where
    a is not a number."""
    if not np.isfinite(a):
        return 1.0
    if scale > 0:
        return abs(a - b) / scale
    return 0.0 if a == b else 1.0


def _loss_gap(got, want) -> float:
    if len(got) < len(want):
        return 1.0
    return max(_rel(a, b, abs(b)) for a, b in zip(got, want))


def _norm_gap(got: dict, want: dict, leaves) -> float:
    med = statistics.median(want[n] for n in leaves)
    return max(_rel(got[n], want[n], max(want[n], med)) for n in leaves)


def sgns_gaps(got: dict, want: dict) -> dict:
    """The gaps of the program's first round from the reference's
    (``reference.sgns_steps``). Both hold ``losses`` (every step of the
    round), ``grads`` (each leaf's gradient norm at steps 1, 2, ...),
    ``change`` (each leaf's change over the first steps) and
    ``round_change`` (over the round)."""
    steps = len(got["grads"][next(iter(got["grads"]))])
    grad = max(_norm_gap({n: v[s] for n, v in got["grads"].items()},
                         {n: v[s] for n, v in want["grads"].items()},
                         want["grads"]) for s in range(steps))
    loud = {n: max(v) for n, v in want["grads"].items()}
    med_loud = statistics.median(loud.values())
    kept = [n for n in loud if loud[n] >= QUIET * med_loud]
    return {"loss_gap": _loss_gap(got["losses"][:FIRST],
                                  want["losses"][:FIRST]),
            "grad_gap": grad,
            "change_gap": _norm_gap(got["change"], want["change"], kept),
            "round_loss_gap": _loss_gap(got["losses"], want["losses"]),
            "round_change_gap": _norm_gap(got["round_change"],
                                          want["round_change"], kept)}


FIRST = 3      # the steps followed one by one


def sgns_config(g, config: dict, trainer: dict) -> dict:
    """The reference's SGNS arguments. It trains with dense Adam: a
    trainer with ``shard_tables`` (row Adam) needs a reference of its
    own."""
    if trainer.get("shard_tables"):
        raise ValueError("the reference trains with dense Adam, not the "
                         "row Adam of shard_tables")
    keys = ("dim", "window", "negatives", "batch_size", "lr", "power")
    adam = config["adam"]
    return dict({k: trainer[k] for k in keys}, vocab=g.n,
                adam_b1=adam["b1"], adam_b2=adam["b2"], adam_eps=adam["eps"])


def first_round_walks(g, plan: dict, seed: int, starts,
                      dtype=torch.float32) -> np.ndarray:
    n = len(starts)
    sample = (np.full(n, seed, np.int64), np.asarray(starts, np.int64),
              np.asarray(starts, np.int64), None)
    return sampled_walks(g, plan, [sample], dtype)


def reference_readings(ref: dict) -> dict:
    """A reference round (``reference.sgns_steps``) read as the program's
    is: its first two steps' gradients."""
    return {"losses": ref["losses"], "change": ref["change"],
            "round_change": ref["round_change"],
            "grads": {n: v[:2] for n, v in ref["grads"].items()}}


def training_against_reference(g, config: dict, plan: dict, trainer: dict,
                               first: dict, train_seed: int) -> dict:
    """The first round's walks, and the trainer's round read step by step
    and whole (``traffic/train_stream.py``) against the reference's."""
    want_walks = first_round_walks(g, plan, first["seed"], first["starts"])
    out = {"round0_mismatch": walk_gaps(first["walks"],
                                        want_walks)["walk_mismatch"]}
    dev = g.row_ptr.device
    walk0 = torch.from_numpy(want_walks).to(dev)
    scfg = sgns_config(g, config, trainer)
    want = reference.sgns_steps(walk0, scfg, train_seed)
    del walk0
    init = reference.init_tables(train_seed, scfg["vocab"], scfg["dim"], dev)
    round_change = {}
    for n, t0 in zip(("emb_in", "emb_out"), init):
        t1 = first["tables"][n].to(dev)
        round_change[n] = float(torch.linalg.vector_norm(
            t1.double() - t0.double()))
        del t1
    got = {"losses": first["losses"], "grads": first["grads"],
           "change": first["change"], "round_change": round_change}
    out.update(sgns_gaps(got, want))
    return out
