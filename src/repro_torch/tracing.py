"""The port's spans and counts: where the time of a run goes, layer by
layer, on the clock the profiler's device trace uses.

    with tracing.span("train.adam", device):    # recorded while profiled
        ...
    with tracing.stage("layout.rows", rows=n):  # recorded always (set-up)
        ...
    for s in tracing.spans(): s.name, s.ns, s.self_ns, s.stream_ms, s.counts

A :func:`span` records only while a ``torch.profiler`` window is open (any
activities, the device's alone included); otherwise it costs one flag read
and returns a shared null context. A :func:`stage` is a set-up stage (the
layout's), recorded whether or not a profiler runs, at the cost of two
clock reads. A recorded span keeps:

* its name, and its host start and end in ``time.time_ns()``, the clock
  kineto stamps host and device events with, read just outside the span's
  ``record_function`` range (the profiler's fast one where torch has it):
  every profiler that traces the host shows the span under its name, and a
  span's interval brackets kineto's;
* the span that encloses it (``parent``, an ``id``), and its self time,
  its duration less what the spans directly inside it took;
* its counts (``supersteps``, ``steps``, ``rounds``);
* with a CUDA ``device``, a pair of CUDA events on the stream current at
  its start, recorded at its start and end: its **stream ms**, the time
  from the stream reaching
  the span's start to finishing the span's last work. That is the device's
  work for the span plus any time the stream idled inside it (a span whose
  launches the host paces reads about its host time). The pair is read
  when :func:`spans` is called after the caller's synchronize (and the
  events are then kept for later spans); until its end event has
  completed, ``stream_ms`` is None.

The newest :data:`CAP` spans are kept in memory; :func:`dropped` counts
those pushed out. There is no exporter: to see the spans, run any
``torch.profiler`` window over the run (its trace export shows them among
the host events) and read :func:`spans` after it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

CAP = 1 << 15
_NULL = contextlib.nullcontext()
# the profiler's range: the C++ one costs ~2 us against ~16 us
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.profiler.record_function


@dataclasses.dataclass
class Span:
    """One recorded span; times in ns of ``time.time_ns()``."""
    name: str
    id: int
    parent: Optional[int]       # the enclosing span's id
    start_ns: int
    counts: dict
    end_ns: int = 0             # 0 while open
    child_ns: int = 0           # the spans directly inside, summed
    stream_ms: Optional[float] = None
    events: Optional[tuple] = None  # (start, end) CUDA events, until read

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.ns - self.child_ns


class _Recorder:
    """The process's spans: the newest :data:`CAP`, each thread's stack
    of open spans (the parents), and the CUDA events already read, to be
    recorded again."""

    def __init__(self):
        self.kept = collections.deque(maxlen=CAP)
        self.free: list = []
        self.dropped = 0
        self.ids = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


def _event():
    free = _REC.free
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _Open:
    """The context of one recorded span."""
    __slots__ = ("name", "device", "counts", "annotate", "rec", "fn",
                 "stream")

    def __init__(self, name, device, counts, annotate):
        self.name, self.device, self.counts = name, device, counts
        self.annotate = annotate

    def __enter__(self):
        stack = _REC.stack()
        with _REC.lock:
            if len(_REC.kept) == CAP:
                _REC.dropped += 1
            rec = Span(self.name, next(_REC.ids),
                       stack[-1].id if stack else None, 0, self.counts)
            _REC.kept.append(rec)
        stack.append(rec)
        self.rec = rec
        self.fn = None
        rec.start_ns = time.time_ns()
        if self.annotate:
            self.fn = _RANGE(self.name)
            self.fn.__enter__()
        dev = self.device
        if dev is not None and dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev)
            start = _event()
            start.record(self.stream)
            rec.events = (start, None)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            end = _event()
            end.record(self.stream)
            rec.events = (rec.events[0], end)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        rec.end_ns = time.time_ns()
        stack = _REC.stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += rec.ns
        return False


def span(name: str, device=None, **counts):
    """A span of the run, recorded while a profiler window is open.
    ``device``: a ``torch.device``; a CUDA one also times the span on its
    current stream (``Span.stream_ms``)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, device, counts, True)


def stage(name: str, **counts):
    """A set-up stage: a span recorded whether or not a profiler runs (its
    ``record_function`` range only while one does), timed on the host."""
    return _Open(name, None, counts, _profiler._is_profiler_enabled)


def spans() -> list:
    """The kept spans that have ended, oldest first, their stream ms read
    where their end event has completed."""
    with _REC.lock:
        kept = list(_REC.kept)
    out = []
    for s in kept:
        if not s.end_ns:
            continue
        if s.events is not None and s.events[1].query():
            start, end = s.events
            s.stream_ms = float(start.elapsed_time(end))
            s.events = None
            _REC.free += (start, end)
        out.append(s)
    return out


def dropped() -> int:
    """Spans pushed out of the kept :data:`CAP` since the process began."""
    return _REC.dropped
