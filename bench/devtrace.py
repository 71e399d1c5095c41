"""The device trace of a run's window, reduced to what the metric readers
read.

The window runs under ``torch.profiler`` (CPU and CUDA activities).  The
harness opens host spans named ``bench.<part>`` with
``torch.profiler.record_function`` around the parts of a step.  A device
operation (kernel, copy or memset) belongs to the span in which the host
launched it: the profiler gives a device operation the correlation id of
the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...), and that call's start lies inside the innermost
``bench.`` span open at that time.  Kernel names are never used to
attribute time.

The window is the host span ``bench.window``.  Busy time is the union of
the device operations' intervals inside it; an idle gap is a stretch of
it with no operation, named by the innermost span the host was in when
the gap began (``window`` outside every step's launch and wait).
"""
from __future__ import annotations

import bisect
import dataclasses

import torch

SPAN_PREFIX = "bench."


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event, times in ns on the host's clock."""

    name: str
    start: int
    end: int
    corr: int = 0            # a launch's and its device operation's id
    host: bool = True        # a host event (else one the card reports)
    annotation: bool = False  # a ``record_function`` span


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    span_device_s: dict[str, float]        # device seconds by span
    device_ops: list[tuple[str, float]]    # seconds by operation name
    idle_gaps: list[tuple[str, float]]     # the longest gaps, by span
    steps: int


def events_from_profiler(prof) -> list[Event]:
    """The raw events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        host = e.device_type() == torch.autograd.DeviceType.CPU
        note = e.is_user_annotation()
        out.append(Event(name=e.name(), start=e.start_ns(), end=e.end_ns(),
                         corr=e.correlation_id(),
                         host=host, annotation=note))
    return out


class _Spans:
    """The ``bench.`` spans, for the innermost one holding a time."""

    def __init__(self, spans: list[Event]):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.spans]

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t)
        best = None
        # spans nest, so the innermost holder starts last among holders;
        # a step holds few spans, so a short look back finds it
        for s in reversed(self.spans[max(0, i - 16):i]):
            if s.start <= t <= s.end:
                if best is None or s.end - s.start < best.end - best.start:
                    best = s
        return None if best is None else best.name[len(SPAN_PREFIX):]


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: list[Event], top: int = 10) -> Summary | None:
    """The window's busy time, device time by span and by operation, and
    its idle gaps; None where the trace holds no step or no device
    operation."""
    spans = [e for e in events if e.host and e.annotation
             and e.name.startswith(SPAN_PREFIX)]
    windows = [s for s in spans if s.name == SPAN_PREFIX + "window"]
    steps = [s for s in spans if s.name == SPAN_PREFIX + "step"]
    device = [e for e in events if not e.host and not e.annotation]
    if not windows or not steps or not device:
        return None
    w0, w1 = windows[0].start, windows[0].end
    index = _Spans(spans)
    # the host's runtime calls, by the correlation id they share with the
    # operation they put on the card
    launched = {e.corr: e.start for e in events
                if e.host and not e.annotation and e.name.startswith("cu")}
    by_span: dict[str, float] = {}
    by_op: dict[str, float] = {}
    inside = []
    for e in device:
        a, b = max(e.start, w0), min(e.end, w1)
        if a >= b:
            continue
        inside.append((a, b))
        host_t = launched.get(e.corr)
        span = index.at(host_t) if host_t is not None else None
        span = span or "window"
        by_span[span] = by_span.get(span, 0.0) + (b - a) * 1e-9
        by_op[e.name] = by_op.get(e.name, 0.0) + (b - a) * 1e-9
    busy = _merge(inside)
    gaps = []
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((index.at(t) or "window", (a - t) * 1e-9))
        t = max(t, b)
    return Summary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        span_device_s=by_span,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps, key=lambda g: -g[1])[:top],
        steps=len(steps))
