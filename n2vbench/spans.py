"""Reading the port's own spans (``repro_torch.tracing``) for the
per-layer metrics.

The port records its spans on the clock the profiler's trace uses, so the
spans of the traced window are those whose host interval overlaps the
window ``[ctx.trace.start_ns, ctx.trace.end_ns]``; the later host-traced
unit lies after it. Per name they are summed: their host ms, their self
ms (each less the spans directly inside it), their stream ms (the CUDA
event pair of a span given a device: the device's work plus any stream
idle inside it; None where a span has none, as on the CPU), and their
counts. The set-up's layout stages are read from the last ``layout``
span, whatever the window. A port that records no spans (one without
``repro_torch.tracing``) gives None, and so do the readers; so does one
that has dropped spans past its cap, whose sums would come out short.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Sums:
    spans: int = 0
    host_ms: float = 0.0
    self_ms: float = 0.0
    stream_ms: Optional[float] = 0.0
    counts: dict = dataclasses.field(default_factory=dict)

    def add(self, s) -> None:
        self.spans += 1
        self.host_ms += s.ns / 1e6
        self.self_ms += s.self_ns / 1e6
        self.stream_ms = None if self.stream_ms is None or \
            s.stream_ms is None else self.stream_ms + s.stream_ms
        for k, v in s.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


def _recorded():
    """The port's recorded spans, or None where it records none or has
    dropped any."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if tracing.dropped():
        return None
    return tracing.spans()


def in_window(ctx) -> Optional[dict]:
    """name -> :class:`Sums` of the spans overlapping the traced window."""
    got = _recorded()
    if got is None or ctx.trace is None:
        return None
    lo, hi = ctx.trace.start_ns, ctx.trace.end_ns
    out: dict = {}
    for s in got:
        if s.end_ns >= lo and s.start_ns <= hi:
            out.setdefault(s.name, Sums()).add(s)
    return out


def per(ctx, name: str, field: str, of: str,
        count: Optional[str] = None) -> Optional[float]:
    """``field`` ("host_ms", "self_ms" or "stream_ms") of the window's
    ``name`` spans over the count ``count`` summed over its ``of`` spans
    (their number where ``count`` is None)."""
    sums = in_window(ctx)
    if not sums or name not in sums or of not in sums:
        return None
    value = getattr(sums[name], field)
    base = sums[of].spans if count is None else \
        sums[of].counts.get(count, 0)
    if value is None or not base:
        return None
    return value / base


def layout_stage_s(name: str) -> Optional[float]:
    """Seconds of the last layout build's ``name`` stages."""
    got = _recorded()
    builds = [s for s in got or () if s.name == "layout"]
    if not builds:
        return None
    last = builds[-1].id
    return sum(s.ns for s in got
               if s.name == name and s.parent == last) / 1e9
