"""The comparisons that decide ``correct`` for SGNS trained by lazy
row-Adam: the trainer's first round (set-up's warm-up round) against the
float64 round of ``reference_rows.py`` on the reference's own walks.

* ``round0_mismatch``: the round's walks against the reference's, the
  share of walker-steps that differ (exact: limit 0).
* ``loss_gap``, ``round_loss_gap``: |loss - ref| / ref at the worst of
  the first :data:`checks.FIRST` steps, and of all the round's steps.
* ``round_change_gap``: by the worst table, the distance between the
  program's tables and the reference's, over the larger of that table's
  and the median table's change in the reference (its tables less the
  initial ones). A table left unchanged reads 1.
* ``untouched_moved``: rows that no step of the round named, in either
  table, whose values are no longer bit-equal to their initial ones.

Everything the program hands in comes through its public API:
``loss_history`` and ``tables``.
"""
from __future__ import annotations

import statistics

import torch

from n2vbench import checks, reference, reference_rows


def rows_config(g, config: dict, trainer: dict) -> dict:
    """The row reference's SGNS arguments, for a trainer with
    ``shard_tables``."""
    if not trainer.get("shard_tables"):
        raise ValueError("the row reference trains with lazy row Adam: "
                         "the trainer needs shard_tables")
    keys = ("dim", "window", "negatives", "batch_size", "lr", "power")
    adam = config["adam"]
    return dict({k: trainer[k] for k in keys}, vocab=g.n,
                adam_b1=adam["b1"], adam_b2=adam["b2"], adam_eps=adam["eps"])


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def change_gap(tables: dict, want: dict, init: dict) -> float:
    """By the worst table, |tables - want| over the larger of that
    table's and the median table's |want - init|."""
    dist, scale = {}, {}
    for n, t0 in init.items():
        w = want[n].double()
        dist[n] = _norm(tables[n].to(w.device).double() - w)
        scale[n] = _norm(w - t0.double())
    med = statistics.median(scale.values())
    return max(checks._rel(dist[n], 0.0, max(scale[n], med))
               for n in init)


def untouched_moved(tables: dict, init: dict, named: dict) -> int:
    """Rows named by no step whose bits differ from their initial ones."""
    moved = 0
    for n, t0 in init.items():
        t = tables[n].to(t0.device, t0.dtype)[:t0.shape[0]].contiguous()
        differs = (t.view(torch.int32) != t0.view(torch.int32)).any(1)
        moved += int((differs & ~named[n].to(t0.device)).sum())
    return moved


def gaps(got: dict, want: dict, init: dict) -> dict:
    """The program's round (``losses``, ``tables``) against the
    reference's (``reference_rows.sgns_rows_steps``), ``init`` the
    initial tables in float32."""
    return {"loss_gap": checks._loss_gap(got["losses"][:checks.FIRST],
                                         want["losses"][:checks.FIRST]),
            "round_loss_gap": checks._loss_gap(got["losses"],
                                               want["losses"]),
            "round_change_gap": change_gap(got["tables"], want["tables"],
                                           init),
            "untouched_moved": untouched_moved(got["tables"], init,
                                               want["named"])}


def training_against_reference(g, config: dict, plan: dict, trainer: dict,
                               first: dict, train_seed: int) -> dict:
    """The first round's walks, losses and tables (``traffic/
    train_rows.py``) against the reference's round on its own walks."""
    want_walks = checks.first_round_walks(g, plan, first["seed"],
                                          first["starts"])
    out = {"round0_mismatch": checks.walk_gaps(
        first["walks"], want_walks)["walk_mismatch"]}
    dev = g.row_ptr.device
    walk0 = torch.from_numpy(want_walks).to(dev)
    cfg = rows_config(g, config, trainer)
    want = reference_rows.sgns_rows_steps([walk0], cfg, train_seed)
    del walk0
    init = dict(zip(reference_rows.TABLES, reference.init_tables(
        train_seed, cfg["vocab"], cfg["dim"], dev)))
    out.update(gaps({"losses": first["losses"], "tables": first["tables"]},
                    want, init))
    return out
