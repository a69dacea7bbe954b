"""The per-layer metrics read from the port's own spans (``spans.py``): a
tiny traced run of each cell on the CPU reads every host-side one as a
positive number and the stream-ms ones as absent (the CPU has no CUDA
events), and the program's counts in the window equal the harness's own.
A port without spans gives no reading and raises nothing."""
from __future__ import annotations

import sys

import pytest

from n2vbench import harness, spans
from n2vbench.tests import tiny

HOST = {"layout.rows_s", "layout.alias_s", "walk.sampler_host_ms_per_step",
        "walk.sampler_host_ms_per_step.rounds",
        "train.negatives_table_ms_per_round"}
STREAM = {"walk.rng_ms_per_step", "walk.rng_ms_per_step.rounds",
          "walk.copy_ms_per_unit", "walk.copy_ms_per_unit.rounds",
          "train.negatives_ms_per_step", "train.scatter_ms_per_step",
          "train.adam_ms_per_step"}


def _traced(monkeypatch, name):
    """A tiny traced run of ``name``, and the context its readers read."""
    seen = []
    real = harness.reader

    def reader(metric):
        read = real(metric)

        def keep(ctx):
            seen.append(ctx)
            return read(ctx)
        return keep
    monkeypatch.setattr(harness, "reader", reader)
    out = tiny.run(name, trace=True)
    return out, seen[0]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_span_metrics_of_a_traced_run(monkeypatch, name):
    out, ctx = _traced(monkeypatch, name)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in tiny.cell(name).per_layer}
    assert listed & HOST and listed & STREAM
    for m in listed & HOST:
        assert out["metrics"][m]["value"] > 0, m
    assert not listed & STREAM & set(out["metrics"])
    sums = spans.in_window(ctx)
    if name == "er20-train":
        assert sums["train.round"].counts == {"steps": ctx.train_steps,
                                              "rounds": 1}
        assert sums["train.adam"].spans == ctx.train_steps
        assert "walk.dispatch" not in sums
    else:
        assert sums["walk.dispatch"].counts["supersteps"] == ctx.supersteps
        assert sums["walk.copy"].spans == len(ctx.walk_units)
        assert "train.round" not in sums


def test_a_port_without_spans_reads_nothing(monkeypatch):
    """A checkout whose port has no ``repro_torch.tracing`` (the benchmark
    laid over an older commit) leaves every span metric out."""
    import repro_torch
    import repro_torch.engine.engine  # noqa: F401  (the port, imported)
    import repro_torch.train.stream  # noqa: F401
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    out = tiny.run("er20-walk-rounds", trace=True)
    assert out["correct"], out["checks"]
    assert not (HOST | STREAM) & set(out["metrics"])
    assert out["metrics"]["layout.build_s"]["value"] > 0


def test_dropped_spans_leave_the_readers_out(monkeypatch):
    """Spans pushed out past the port's cap would leave the window's sums
    short, so every span metric is then left out."""
    from repro_torch import tracing
    monkeypatch.setattr(tracing._REC, "dropped", 1)
    out = tiny.run("er20-walk-rounds", trace=True)
    assert out["correct"], out["checks"]
    assert not (HOST | STREAM) & set(out["metrics"])
    assert out["metrics"]["layout.build_s"]["value"] > 0
