"""Reading the device's activity out of a ``torch.profiler`` trace.

A traced window runs under the profiler and ends in a synchronize. The
metrics' window traces the device's activity alone, since recording every
host op slows a host-paced loop; a second, shorter window traces the host
too, with one annotation, ``n2vbench.window``, around it, and serves only
to name the idle gaps. From the kineto events:

* busy seconds: the union of the device intervals (kernels, copies,
  sets), so work that overlaps on two streams counts once and the busy
  share never passes 1;
* device operations by name: calls and summed seconds;
* idle gaps: the stretches of the window in which the device ran
  nothing, each named by the innermost host event that covers its middle
  (an aten op, a runtime call, or an annotation of the benchmark's).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
import warnings

import torch

MARK = "n2vbench."
WINDOW = MARK + "window"
COPIES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    """The device and host events of one traced window, in ns."""
    window_s: float                 # host clock, ending in a synchronize
    start_ns: int                   # the window's annotation
    end_ns: int
    device: list                    # (name, start, end)
    host: list                      # (name, start, end)


def _events(prof):
    """(name, device?, start ns, end ns) of every kineto event but the
    device-side copies of host annotations."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        name = e.name()
        if on_device and (name.startswith(MARK) or getattr(
                e, "is_user_annotation", lambda: False)()):
            continue
        start = e.start_ns()
        yield name, on_device, start, start + e.duration_ns()


def traced(fn, device, host: bool = False):
    """Run ``fn`` under the profiler, tracing the device's activity and,
    with ``host``, the host's; returns (its result, a Trace). Without the
    host's events the window is the span of the device's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        # a profile without a schedule is one cycle: nothing is cleared
        warnings.filterwarnings("ignore", "Profiler clears events")
        prof = profile(activities=acts)
        prof.start()
    try:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    finally:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Profiler clears events")
            prof.stop()
    dev, hosts, bounds = [], [], None
    for name, on_device, start, end in _events(prof):
        if on_device:
            if end > start:
                dev.append((name, start, end))
        elif name == WINDOW:
            bounds = (start, end)
        else:
            hosts.append((name, start, end))
    if bounds is None:
        bounds = (min((d[1] for d in dev), default=0),
                  max((d[2] for d in dev), default=0))
    return out, Trace(window_s, bounds[0], bounds[1], dev, hosts)


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(t: Trace) -> float:
    """Seconds of the window in which the device ran anything."""
    spans = merged((max(s, t.start_ns), min(e, t.end_ns))
                   for _, s, e in t.device if e > t.start_ns
                   and s < t.end_ns)
    return min(sum(e - s for s, e in spans) / 1e9, t.window_s)


def kernels(t: Trace):
    """The device events that are kernels (not copies or sets)."""
    return [ev for ev in t.device if not ev[0].startswith(COPIES)]


def by_name(events) -> dict:
    """name -> [calls, seconds]."""
    out: dict = {}
    for name, s, e in events:
        acc = out.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (e - s) / 1e9
    return out


def matching(t: Trace, part: str):
    """(calls, seconds) of the kernels whose name contains ``part``."""
    calls, secs = 0, 0.0
    for name, (c, s) in by_name(kernels(t)).items():
        if part in name:
            calls += c
            secs += s
    return calls, secs


def top_ops(t: Trace, n: int = 10):
    """The ``n`` device operations that took most time: [name, seconds]."""
    ops = sorted(by_name(t.device).items(), key=lambda kv: -kv[1][1])
    return [[name[:160], secs] for name, (_, secs) in ops[:n]]


def idle_gaps(t: Trace, n: int = 10, min_ns: int = 2000):
    """Idle time of the window by what the host was doing: the gaps of
    at least ``min_ns`` between the device's busy spans (and before the
    first and after the last), each named by the innermost host event
    covering its middle, summed by name. The ``n`` largest, [name,
    seconds]."""
    spans = merged((s, e) for _, s, e in t.device)
    edges = [t.start_ns] + [x for s, e in spans for x in (s, e)] + \
        [t.end_ns]
    host = sorted(t.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    marks = [h for h in host if h[0].startswith(MARK)]
    out: dict = {}
    for i in range(0, len(edges), 2):
        lo, hi = max(edges[i], t.start_ns), min(edges[i + 1], t.end_ns)
        if hi - lo < min_ns:
            continue
        mid = (lo + hi) // 2
        name = WINDOW
        j = bisect.bisect_right(starts, mid) - 1
        best = None
        for h in host[max(0, j - 256):j + 1]:
            if h[1] <= mid < h[2] and (best is None or h[1] >= best[1]):
                best = h
        if best is None:
            for h in marks:
                if h[1] <= mid < h[2] and (best is None or h[1] >= best[1]):
                    best = h
        if best is not None:
            name = best[0]
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e9
    ranked = sorted(out.items(), key=lambda kv: -kv[1])
    return [[name[:160], secs] for name, secs in ranked[:n]]
