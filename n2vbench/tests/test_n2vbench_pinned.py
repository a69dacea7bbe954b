"""``walk.copy_pinned_share`` (and its ``.rounds`` reader) on hand-made
spans: the ``pinned`` counts of the window's ``walk.copy`` spans over
their number, in %; nothing where the window has no such span, where the
spans count no ``pinned`` (the CPU's copy, or a port without a pinned
copy), or where the port dropped spans past its cap."""
from __future__ import annotations

import types

import pytest

from n2vbench import harness
from n2vbench.tests import tiny  # noqa: F401  (puts src/ on the path)
from repro_torch import tracing

WINDOW = (1_000, 2_000)


def _span(name, start, i, **counts):
    return tracing.Span(name, i, None, start, counts, end_ns=start + 10)


CASES = {
    "all pinned": ([("walk.copy", 1_100, {"pinned": 1}),
                    ("walk.copy", 1_500, {"pinned": 1})], 0, 100.0),
    "one of two": ([("walk.copy", 1_100, {"pinned": 1}),
                    ("walk.copy", 1_500, {"pinned": 0})], 0, 50.0),
    "outside the window": ([("walk.copy", 100, {"pinned": 0}),
                            ("walk.copy", 1_500, {"pinned": 1}),
                            ("walk.copy", 2_500, {"pinned": 0})], 0, 100.0),
    "no copy span": ([("walk.dispatch", 1_100, {"supersteps": 8})], 0,
                     None),
    "no pinned count": ([("walk.copy", 1_100, {}),
                         ("walk.copy", 1_500, {})], 0, None),
    "dropped spans": ([("walk.copy", 1_100, {"pinned": 1})], 1, None),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("metric", ["walk.copy_pinned_share",
                                    "walk.copy_pinned_share.rounds"])
def test_pinned_share_on_hand_made_spans(monkeypatch, metric, case):
    made, dropped, want = CASES[case]
    got = [_span(name, start, i, **counts)
           for i, (name, start, counts) in enumerate(made)]
    monkeypatch.setattr(tracing, "spans", lambda: got)
    monkeypatch.setattr(tracing._REC, "dropped", dropped)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(
        start_ns=WINDOW[0], end_ns=WINDOW[1]))
    assert harness.reader(metric)(ctx) == want
