"""The row-Adam cell (``wec20-train-rowadam``: the ``train_rows`` kind,
``reference_rows.py``, ``checks_rows.py``) in whole runs at a tiny size
on the CPU: ``correct`` holds for the port as it is, and comes out false
with its row-Adam step broken underneath, once for each fault the check
must see; the traced run reads the new metrics the CPU allows, and the
benchmark's count of the rows a step names equals the port's."""
from __future__ import annotations

import ast
import time

import numpy as np
import pytest
import torch

from n2vbench import harness, reference_rows, spans
from n2vbench.tests import tiny

import repro_torch.train.shard as shard_mod  # noqa: E402
import repro_torch.train.stream as stream_mod  # noqa: E402
from repro_torch.optim.optimizers import (Optimizer, adam,  # noqa: E402
                                          adam_rows)

NAME = "wec20-train-rowadam"
STREAM = {"train.rows_dedup_ms_per_step", "train.rows_gather_ms_per_step",
          "train.rows_scatter_ms_per_step", "train.rows_adam_ms_per_step",
          "train.negatives_ms_per_step"}


def _cell(k: int = 7) -> harness.Cell:
    """The tiny cell; at ``k=10`` (1,024 rows, 768 walked a round) a
    round names a minority of the rows and the unique buffers hold fill
    rows."""
    c = tiny.cell(NAME)
    c.config["k"] = k
    return c


def _run(cell, trace=False, seed=2 ** 31 + 77):
    return harness.run(cell, seed, 0.5, trace, "cpu", time.perf_counter(),
                       log=lambda *_: None)


def _traced(monkeypatch, cell):
    seen = []
    real = harness.reader

    def reader(metric):
        read = real(metric)

        def keep(ctx):
            seen.append(ctx)
            return read(ctx)
        return keep
    monkeypatch.setattr(harness, "reader", reader)
    return _run(cell, trace=True), seen[0]


def test_sound_run_is_correct():
    out = tiny.run(NAME)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert set(out["checks"]) >= {"untouched_moved", "round_change_gap",
                                  "round_loss_gap", "loss_gap"}


def test_traced_run_reads_the_host_metrics(monkeypatch):
    """On the CPU: the layout's, the negatives' table and the rows moved
    a named row; the stream-ms and device-trace ones are absent."""
    out, ctx = _traced(monkeypatch, _cell(10))
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for m in ("layout.build_s", "layout.rows_s", "layout.alias_s",
              "train.negatives_table_ms_per_round",
              "train.rows_moved_per_distinct"):
        assert got[m]["value"] > 0, m
    assert got["train.rows_moved_per_distinct"]["value"] >= 1.0
    assert not STREAM & set(got)
    sums = spans.in_window(ctx)
    assert sums["train.rows.adam"].spans == ctx.train_steps == \
        ctx.rows["steps"]
    for name in ("train.rows.dedup", "train.rows.gather",
                 "train.rows.scatter", "train.negatives"):
        assert sums[name].spans == ctx.train_steps, name


def test_distinct_replay_equals_the_port(monkeypatch):
    """The rows the benchmark counts from the replayed ids equal the
    distinct ids in the port's unique buffers (those before the fill),
    over the traced round."""
    real = shard_mod.unique_padded
    counted = []

    def count(x, size, fill):
        out = real(x, size, fill)
        counted.append(int((out != fill).sum()))
        return out
    monkeypatch.setattr(shard_mod, "unique_padded", count)
    steps = {}
    real_consume = stream_mod.StreamingSGNSTrainer.consume

    def consume(self, walks):
        before = len(counted)
        real_consume(self, walks)
        steps[self._round - 1] = counted[before:]
    monkeypatch.setattr(stream_mod.StreamingSGNSTrainer, "consume", consume)
    out, ctx = _traced(monkeypatch, _cell(10))
    assert out["correct"], out["checks"]
    traced = steps[1]                  # the window's round follows set-up's
    assert ctx.rows == {"distinct": sum(traced), "steps": len(traced) // 2}


def _dense(params, opt_state, c, x, valid, perm2d, prob, alias, key, *,
           opt, negatives, backend, n_pairs, u_in, u_out, mesh=None):
    """Dense Adam in place of the row Adam: the dense trainer's epoch."""
    return stream_mod._train_epoch(
        params, opt_state, c, x, valid, perm2d, prob, alias, key,
        opt=adam(0.025), negatives=negatives, backend=backend,
        n_pairs=n_pairs)


def _half_batch(grads):
    """Half of the batch masked, the mean taken over the rest."""
    def broken(ci, po, no, valid, backend="jnp"):
        keep = torch.zeros_like(valid)
        keep[:keep.shape[0] // 2] = 1.0
        return grads(ci, po, no, valid * keep, backend)
    return broken


def _frozen(lr):
    """A row Adam whose steps leave the tables as they are."""
    real = adam_rows(lr)

    def update(g_rows, rows_state, count):
        upd, mu, nu = real.update(g_rows, rows_state, count)
        return torch.zeros_like(upd), mu, nu
    return Optimizer(real.init, update, None)


def _fill_into_row0(owned):
    """The fill rows' writes land on real row 0, not the scratch row."""
    def broken(u, row0, n_loc):
        loc, mine = owned(u, row0, n_loc)
        return torch.where(loc == n_loc, 0, loc), mine
    return broken


FAULTS = {
    "dense": lambda mp: mp.setattr(stream_mod, "train_epoch_sharded",
                                   _dense),
    "half_batch": lambda mp: mp.setattr(
        shard_mod, "sgns_row_grads", _half_batch(shard_mod.sgns_row_grads)),
    "state_unchanged": lambda mp: mp.setattr(stream_mod, "adam_rows",
                                             _frozen),
    "fill_into_row0": lambda mp: mp.setattr(
        shard_mod, "_owned", _fill_into_row0(shard_mod._owned)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_row_fault_is_caught(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run(_cell(10))
    assert not out["correct"], out["checks"]
    assert np.isfinite([c["value"] for c in out["checks"].values()]).all()
    if fault == "fill_into_row0":
        assert out["checks"]["untouched_moved"]["value"] > 0


@pytest.mark.parametrize("name", ["reference_rows.py", "checks_rows.py",
                                  "control_rows.py"])
def test_reference_imports_nothing_of_the_program(name):
    path = harness.BENCH / name
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
    assert roots <= {"__future__", "argparse", "json", "numpy", "pathlib",
                     "statistics", "sys", "time", "torch", "n2vbench"}


def test_reference_rows_counts_the_steps():
    g = torch.tensor(np.random.default_rng(3).integers(
        0, 50, size=(4, 9)), dtype=torch.int64)
    cfg = {"vocab": 64, "dim": 4, "window": 3, "negatives": 2,
           "batch_size": 16, "lr": 0.025, "power": 0.75, "adam_b1": 0.9,
           "adam_b2": 0.999, "adam_eps": 1e-8}
    counts = np.bincount(g.reshape(-1).numpy(), minlength=64)
    got = reference_rows.distinct_rows(g, cfg, 5, 0, counts)
    run = reference_rows.sgns_rows_steps([g], cfg, 5)
    assert got["steps"] == len(run["losses"])
    assert 0 < got["distinct"] <= got["steps"] * 16 * 4


def test_controls_read_over_the_limits():
    """At the tiny size the bf16 reference and each planted fault read
    over at least one of the cell's limits (``control_rows.py``, the
    readings that set the limits' upper ends at the cell's size)."""
    from n2vbench import control_rows, graphs
    cell = _cell(10)
    seeds = harness.sub_seeds(2 ** 31 + 5)
    g = graphs.rmat_graph(cell.config, seeds["graph"], "cpu")
    out = control_rows.train_controls(g, cell.config, cell.mix, seeds,
                                      np.random.default_rng(1))
    limits = cell.mix["limits"]
    for name in ("bf16",) + reference_rows.FAULTS:
        assert any(v > limits[k] for k, v in out[name].items()), \
            (name, out[name])
