"""The port's own spans in a traced window, reduced to what their metric
readers read.

The port opens host spans named ``repro_torch.<name>`` while a
``torch.profiler`` records (``repro_torch.common.trace``): ``model``,
``sparse``, ``k1``, ``dense`` and ``mlp``.  They are read here from the
same ``devtrace.Event`` list that ``devtrace.summarize`` reduces, on the
same clock: a device operation belongs to the innermost port span that
holds the start of the runtime call that launched it (its self time), or
to ``outside`` where no port span holds it.  Each stretch of the window
with no device operation is split instant by instant by the innermost
port span the host was in over the stretch, ``outside`` where it was in
none, so a gap is put down to what the host did all through it and not
only where it began.

Spans of one thread nest, and a traced step holds more port spans than
``devtrace``'s look-back of 16, so the innermost span over time is worked
out once, by a sweep, as disjoint pieces.  The GPU-side mirrors of the
spans (device events that are annotations) are not read.
"""
from __future__ import annotations

import bisect
import dataclasses

from bench.devtrace import SPAN_PREFIX, Event, _merge

PREFIX = "repro_torch."
OUTSIDE = "outside"


@dataclasses.dataclass
class Summary:
    device_s: dict[str, float]        # device seconds by innermost port span
    idle_by_span_s: dict[str, float]  # the window's idle seconds, likewise
    steps: int


def _pieces(spans: list[Event]) -> list[tuple[int, int, str]]:
    """The innermost span over time: disjoint (start, end, name) pieces in
    order, names without the prefix; a span is cut at the end of the span
    it starts in."""
    pieces = []
    stack: list[tuple[int, str]] = []        # (end, name), innermost last
    t = 0

    def close(upto):
        nonlocal t
        while stack and stack[-1][0] <= upto:
            end, name = stack.pop()
            pieces.append((t, end, name))
            t = end

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        close(s.start)
        if stack:
            pieces.append((t, s.start, stack[-1][1]))
        end = min(s.end, stack[-1][0]) if stack else s.end
        stack.append((end, s.name[len(PREFIX):]))
        t = s.start
    close(float("inf"))
    return [p for p in pieces if p[0] < p[1]]


class Innermost:
    """The innermost port span at each host time."""

    def __init__(self, spans: list[Event]):
        self.pieces = _pieces(spans)
        self.starts = [p[0] for p in self.pieces]

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.pieces[i][1]:
            return self.pieces[i][2]
        return OUTSIDE

    def split(self, a: int, b: int, out: dict[str, float]) -> None:
        """Add [a, b)'s seconds to ``out`` by the innermost span."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        t = a
        while t < b and i < len(self.pieces) and self.pieces[i][0] < b:
            pa, pb, name = self.pieces[i]
            i += 1
            if pb <= t:
                continue
            if pa > t:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (pa - t) * 1e-9
                t = pa
            e = min(pb, b)
            out[name] = out.get(name, 0.0) + (e - t) * 1e-9
            t = e
        if t < b:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - t) * 1e-9


def summarize(events: list[Event]) -> Summary | None:
    """Device time and idle time by the port's innermost span; None where
    the trace holds no window, no step, no device operation or no port
    span."""
    spans = [e for e in events if e.host and e.annotation
             and e.name.startswith(PREFIX)]
    windows = [e for e in events if e.host and e.annotation
               and e.name == SPAN_PREFIX + "window"]
    steps = sum(1 for e in events if e.host and e.annotation
                and e.name == SPAN_PREFIX + "step")
    device = [e for e in events if not e.host and not e.annotation]
    if not spans or not windows or not steps or not device:
        return None
    w0, w1 = windows[0].start, windows[0].end
    index = Innermost(spans)
    launched = {e.corr: e.start for e in events
                if e.host and not e.annotation and e.name.startswith("cu")}
    device_s: dict[str, float] = {}
    inside = []
    for e in device:
        a, b = max(e.start, w0), min(e.end, w1)
        if a >= b:
            continue
        inside.append((a, b))
        host_t = launched.get(e.corr)
        span = OUTSIDE if host_t is None else index.at(host_t)
        device_s[span] = device_s.get(span, 0.0) + (b - a) * 1e-9
    idle: dict[str, float] = {}
    t = w0
    for a, b in _merge(inside) + [(w1, w1)]:
        if a > t:
            index.split(t, a, idle)
        t = max(t, b)
    return Summary(device_s=device_s, idle_by_span_s=idle, steps=steps)


def idle_note(s: Summary | None) -> str:
    """One line: the window's idle ms a step by innermost port span."""
    if s is None:
        return "program idle: no port span in the trace"
    names = ("model", "sparse", "k1", "dense", "mlp", OUTSIDE)
    names += tuple(sorted(set(s.idle_by_span_s) - set(names)))
    return "program idle_ms a step " + " ".join(
        f"{n} {1e3 * s.idle_by_span_s.get(n, 0.0) / s.steps:.6f}"
        for n in names)


def span_ms(run, name: str) -> float | None:
    """Device ms a step in port span ``name`` (self time) of a run whose
    ``program`` holds this reduction; None where it holds none or the span
    launched nothing."""
    s = getattr(run, "program", None)
    if s is None:
        return None
    t = s.device_s.get(name, 0.0)
    return 1e3 * t / s.steps if t > 0 else None
