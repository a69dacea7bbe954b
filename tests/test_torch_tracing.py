"""The port's spans (``repro_torch.tracing``): recorded only while a
profiler runs (the layout's stages always), nested with their parents and
self time, on the clock kineto stamps its events with, counting what the
benchmark divides by, and changing no result.

The test marked ``cuda`` reads the spans' stream ms on the card; this file
imports no JAX, so it runs there too::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_tracing.py
"""
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.train.stream import StreamingSGNSTrainer

SMALL = "wec:k=8,deg=12,seed=1"          # 256 vertices
SPAN_PREFIXES = ("layout", "walk.", "train.")
CLOCK_SLACK_NS = 50_000


def _since(t0: int) -> list:
    return [s for s in tracing.spans() if s.start_ns >= t0]


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under a profiler; (its result, the kineto host events
    named as the port's spans)."""
    with profile(activities=list(activities)) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(SPAN_PREFIXES)
              and e.device_type() == torch.autograd.DeviceType.CPU]
    return out, events


def _engine(backend="fused", pipeline=False, mode="exact", cap=None,
            length=6, device="cpu"):
    return WalkEngine.build(SMALL, WalkPlan(
        backend=backend, pipeline=pipeline, mode=mode, approx_eps=5e-2,
        cap=cap, p=0.5, q=2.0, length=length), device=device)


def _trainer(n, device="cpu"):
    return StreamingSGNSTrainer(n, dim=16, window=3, negatives=2,
                                batch_size=128, seed=5,
                                sgns_backend="fused", device=device)


def test_off_records_nothing_but_the_layout(monkeypatch):
    """No profiler: ``span`` is the shared null context, the layout's
    stages are the only spans kept, and no ``record_function`` is
    entered."""
    entered = []
    real = tracing._RANGE
    monkeypatch.setattr(tracing, "_RANGE",
                        lambda name: entered.append(name) or real(name))
    t0 = time.time_ns()
    eng = _engine(cap=8)
    walks = eng.run(seed=3).walks
    tr = _trainer(eng.n)
    tr.consume(walks)
    assert next(iter(eng.rounds(1, seed=4))).walks.shape == walks.shape
    assert tracing.span("walk.rng", torch.device("cpu")) is tracing._NULL
    names = [s.name for s in _since(t0)]
    assert names == ["layout", "layout.rows", "layout.alias"]
    assert entered == []


def test_layout_stages_scope_the_build():
    """``layout`` holds ``layout.rows`` and ``layout.alias`` as children;
    its self time is the rest of the build."""
    t0 = time.time_ns()
    _engine(cap=8)
    lay, rows, alias = _since(t0)
    assert lay.counts == rows.counts == alias.counts == {}
    assert rows.parent == alias.parent == lay.id and lay.parent is None
    assert lay.self_ns == lay.ns - rows.ns - alias.ns
    assert lay.start_ns <= rows.start_ns <= rows.end_ns <= \
        alias.start_ns <= alias.end_ns <= lay.end_ns


def test_nesting_parents_self_time_and_counts():
    def nest():
        with tracing.span("walk.dispatch", supersteps=2):
            for _ in range(2):
                with tracing.span("walk.draw"):
                    with tracing.span("walk.rng"):
                        time.sleep(0.002)
                    time.sleep(0.001)
    t0 = time.time_ns()
    _profiled(nest)
    got = _since(t0)
    assert [s.name for s in got] == ["walk.dispatch"] + \
        ["walk.draw", "walk.rng"] * 2
    top, d1, r1, d2, r2 = got
    assert top.parent is None and top.counts == {"supersteps": 2}
    assert d1.parent == d2.parent == top.id
    assert r1.parent == d1.id and r2.parent == d2.id
    assert r1.self_ns == r1.ns >= 2_000_000
    assert d1.self_ns == d1.ns - r1.ns and d1.self_ns >= 1_000_000
    assert top.self_ns == top.ns - d1.ns - d2.ns
    assert all(s.stream_ms is None and s.counts == {} for s in got[1:])


def test_a_span_closes_on_an_exception():
    t0 = time.time_ns()

    def boom():
        with tracing.span("train.round", steps=1):
            with tracing.span("train.adam"):
                raise RuntimeError("inside")
    with pytest.raises(RuntimeError, match="inside"):
        _profiled(boom)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("walk.copy"):
            pass
    outer, inner, after = _since(t0)
    assert inner.parent == outer.id and after.parent is None
    assert outer.end_ns >= inner.end_ns > 0


def test_cap_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 4)
    monkeypatch.setattr(tracing, "_REC", tracing._Recorder())

    def many():
        for i in range(7):
            with tracing.span("walk.rng", i=i):
                pass
    _profiled(many)
    assert [s.counts["i"] for s in tracing.spans()] == [3, 4, 5, 6]
    assert tracing.dropped() == 3


@pytest.mark.parametrize("pipeline", [False, True])
def test_spans_bracket_the_kineto_events(pipeline):
    """Each span's host event in the profiler's trace lies inside the
    span's recorded ``time.time_ns()`` interval: one clock."""
    eng = _engine(pipeline=pipeline)
    tr = _trainer(eng.n)
    walks = eng.run(seed=1).walks
    t0 = time.time_ns()
    _, events = _profiled(lambda: (eng.run(seed=2), tr.consume(walks)))
    got = _since(t0)
    assert len(events) == len(got) > 0
    by_name: dict = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        by_name.setdefault(e.name(), []).append(e)
    for name, evs in by_name.items():
        mine = [s for s in got if s.name == name]
        assert len(mine) == len(evs), name
        for s, e in zip(mine, evs):
            assert s.start_ns - CLOCK_SLACK_NS <= e.start_ns(), name
            assert e.start_ns() + e.duration_ns() <= \
                s.end_ns + CLOCK_SLACK_NS, name


@pytest.mark.parametrize("backend,pipeline,mode", [
    ("reference", False, "exact"), ("fused", False, "exact"),
    ("fused", True, "exact"), ("fused", False, "approx")])
def test_walk_spans_count_the_supersteps(backend, pipeline, mode):
    """A dispatch counts ``plan.length`` supersteps; each superstep's
    draw holds its RNG, in one span on the fused exact path; one copy."""
    length = 5
    eng = _engine(backend, pipeline, mode, length=length)
    t0 = time.time_ns()
    _profiled(lambda: eng.run(starts=np.arange(40), seed=9))
    got = _since(t0)
    (disp,) = [s for s in got if s.name == "walk.dispatch"]
    (copy,) = [s for s in got if s.name == "walk.copy"]
    assert disp.counts == {"supersteps": length} and copy.counts == {}
    draws = [s for s in got if s.name == "walk.draw"]
    rng = [s for s in got if s.name == "walk.rng"]
    assert len(draws) == (2 if pipeline else length)
    assert all(d.parent == disp.id for d in draws)
    ids = {disp.id} | {d.id for d in draws}
    assert rng and all(r.parent in ids and r.self_ns == r.ns for r in rng)
    assert sum(r.parent != disp.id for r in rng) >= len(draws)
    if backend == "fused" and mode == "exact" and not pipeline:
        assert [sum(r.parent == d.id for r in rng) for d in draws] == \
            [1] * length


def test_round_counts_its_steps():
    """``train.round`` counts ceil(pairs / batch) steps and one round; the
    negatives, scatter and Adam spans come once a step inside it."""
    eng = _engine(length=8)
    walks = eng.run(seed=1).walks
    tr = _trainer(eng.n)
    t0 = time.time_ns()
    _profiled(lambda: tr.consume(walks))
    got = _since(t0)
    (rnd,) = [s for s in got if s.name == "train.round"]
    w, length = walks.shape
    pairs = 2 * w * sum(length - off for off in range(1, 4))
    steps = math.ceil(pairs / 128)
    assert rnd.counts == {"steps": steps, "rounds": 1}
    for name, n in (("train.negatives_table", 1), ("train.negatives", steps),
                    ("train.scatter", steps), ("train.adam", steps)):
        mine = [s for s in got if s.name == name]
        assert len(mine) == n and all(s.parent == rnd.id for s in mine)


@pytest.mark.parametrize("backend,pipeline,mode,cap", [
    ("reference", False, "exact", 8), ("fused", False, "exact", 8),
    ("fused", True, "exact", None), ("fused", False, "approx", 8),
    ("reference", False, "approx_always", 8)])
def test_walks_equal_with_tracing_on_and_off(backend, pipeline, mode, cap):
    eng = _engine(backend, pipeline, mode, cap=cap)
    off = [eng.run(seed=7).walks] + \
        [r.walks for r in eng.rounds(2, seed=8)]
    on, _ = _profiled(lambda: [eng.run(seed=7).walks] +
                      [r.walks for r in eng.rounds(2, seed=8)])
    for a, b in zip(off, on):
        assert np.array_equal(a, b)


def test_training_equal_with_tracing_on_and_off():
    eng = _engine(length=8)
    rounds = [r.walks for r in eng.rounds(2, seed=3)]
    off, on = _trainer(eng.n), _trainer(eng.n)
    for walks in rounds:
        off.consume(walks)
    _profiled(lambda: [on.consume(walks) for walks in rounds])
    assert np.array_equal(off.loss_history(), on.loss_history())
    for name, t in off.tables().items():
        assert torch.equal(t, on.tables()[name])


@pytest.mark.cuda
def test_stream_ms_on_the_card():
    """On the card the RNG, copy, negatives, scatter and Adam spans read
    stream ms, each no longer than its host start to the synchronize; the
    second time, on the CUDA events the first reading freed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    eng = _engine(device=dev, length=8)
    walks = eng.run(seed=1).walks
    tr = _trainer(eng.n, device=dev)
    tr.consume(walks)
    torch.cuda.synchronize(dev)

    def work():
        eng.run(seed=2)
        tr.consume(walks)
        torch.cuda.synchronize(dev)
        return time.time_ns()
    timed = ("walk.rng", "walk.copy", "train.negatives", "train.scatter",
             "train.adam")
    for _ in range(2):
        t0 = time.time_ns()
        t_sync, _ = _profiled(work, (ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA))
        got = _since(t0)
        for name in timed:
            mine = [s for s in got if s.name == name]
            assert mine, name
            for s in mine:
                assert s.stream_ms is not None and s.stream_ms >= 0, name
                assert s.stream_ms * 1e6 <= t_sync - s.start_ns, name
        assert all(s.stream_ms is None for s in got
                   if s.name not in timed)
        assert len(tracing._REC.free) >= 2 * len(
            [s for s in got if s.name in timed])


ROW_SPANS = ("train.negatives", "train.rows.dedup", "train.rows.gather",
             "train.rows.scatter", "train.rows.adam")


def _row_trainer(n, device="cpu"):
    return StreamingSGNSTrainer(n, dim=16, window=3, negatives=2,
                                batch_size=128, seed=5,
                                sgns_backend="fused", shard_tables=True,
                                device=device)


def test_row_adam_spans_come_once_a_step():
    """With ``shard_tables`` the negatives, dedup, gather, scatter and
    row-Adam spans come once a step inside ``train.round``; the row-Adam
    span counts the unique buffers' rows, ``u_in + u_out``."""
    eng = _engine(length=8)
    walks = eng.run(seed=1).walks
    tr = _row_trainer(eng.n)
    t0 = time.time_ns()
    _profiled(lambda: tr.consume(walks))
    got = _since(t0)
    (rnd,) = [s for s in got if s.name == "train.round"]
    steps = rnd.counts["steps"]
    assert steps > 1
    for name in ROW_SPANS:
        mine = [s for s in got if s.name == name]
        assert len(mine) == steps and all(s.parent == rnd.id for s in mine)
    adam = [s for s in got if s.name == "train.rows.adam"]
    assert all(s.counts == {"rows": tr._u_in + tr._u_out} for s in adam)
    assert not [s for s in got if s.name in ("train.adam", "train.scatter")]


def test_row_adam_unprofiled_records_no_span():
    eng = _engine(length=8)
    walks = eng.run(seed=1).walks
    tr = _row_trainer(eng.n)
    t0 = time.time_ns()
    tr.consume(walks)
    assert not [s for s in _since(t0) if s.name.startswith("train.")]


def test_row_adam_equal_with_tracing_on_and_off():
    eng = _engine(length=8)
    rounds = [r.walks for r in eng.rounds(2, seed=3)]
    off, on = _row_trainer(eng.n), _row_trainer(eng.n)
    for walks in rounds:
        off.consume(walks)
    _profiled(lambda: [on.consume(walks) for walks in rounds])
    assert np.array_equal(off.loss_history(), on.loss_history())
    for name, t in off.tables().items():
        assert torch.equal(t, on.tables()[name])


@pytest.mark.cuda
def test_row_adam_stream_ms_on_the_card():
    """On the card the row-Adam step's spans read stream ms, each no
    longer than its host start to the synchronize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    eng = _engine(device=dev, length=8)
    walks = eng.run(seed=1).walks
    tr = _row_trainer(eng.n, device=dev)
    tr.consume(walks)
    torch.cuda.synchronize(dev)

    def work():
        tr.consume(walks)
        torch.cuda.synchronize(dev)
        return time.time_ns()
    t0 = time.time_ns()
    t_sync, _ = _profiled(work, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    got = _since(t0)
    for name in ROW_SPANS:
        mine = [s for s in got if s.name == name]
        assert mine, name
        for s in mine:
            assert s.stream_ms is not None and s.stream_ms >= 0, name
            assert s.stream_ms * 1e6 <= t_sync - s.start_ns, name
