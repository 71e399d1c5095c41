#!/usr/bin/env python3
"""One traced run of a cell of the port's benchmark, read also by the
port's own spans.

    python3 tools/port_spans.py --workload rm2.bulk --seed 7 --seconds 20

from the root of a checkout, on a CUDA card.  Runs ``bench/run.py`` with
``--trace 1`` as it is (its result line and standard error unchanged),
keeps the window's profiler events that ``bench/devtrace.py`` reduces,
reduces the same events with ``bench/progtrace.py``, and prints one more
JSON line last:

- ``metrics``: the readers of the port's spans (``bench/metrics/
  k1_ms.py``, ``mlp_ms.py``, ``dense_self_ms.py``, ``program_idle_ms.py``),
  ms a step;
- ``harness``: the same window's device ms a step in ``bench.sparse`` and
  ``bench.dense``, and its idle ms a step;
- ``idle_ms``: the idle ms a step by innermost port span;
- ``spans_per_step``: the port's host spans in the window, a step;
- ``k1``: where the window's K1 kernels sit against the port's K1 spans
  (``k1_placement``);
- ``ops_ms``: each port span's longest device operations, ms a step.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# as bench/run.py sets it, before torch is imported here
os.environ["OMP_NUM_THREADS"] = "1"

from bench import devtrace, harness, progtrace  # noqa: E402

READERS = ("k1_ms", "mlp_ms", "dense_self_ms", "program_idle_ms")


def _window_and_calls(events: list[devtrace.Event]):
    """The ``bench.window`` span, and each runtime call's start by the
    correlation id it shares with the operation it put on the card."""
    (window,) = [e for e in events if e.host and e.annotation
                 and e.name == "bench.window"]
    calls = {e.corr: e.start for e in events
             if e.host and not e.annotation and e.name.startswith("cu")}
    return window, calls


def k1_placement(events: list[devtrace.Event]) -> dict:
    """Where the window's K1 kernels sit against the port's K1 spans, and
    how far the profiler's mapping of the card's times onto the host's
    clock strays: ``in_span``, every K1 kernel launched inside exactly one
    ``repro_torch.k1`` span (host clocks only); ``lead_us_median`` and
    ``lead_us_min`` of (kernel start - that span's start); over every
    device operation launched in the window, ``before_launch``, how many
    start before their own runtime call, ``launch_lead_us_min``, the least
    (start - that call's start), and ``after_window_us_max``, the most
    (end - the window's end): the window waits for every step it
    launched, so a sound mapping keeps these at or above 0, and at or
    below 0."""
    window, launched = _window_and_calls(events)
    spans = [e for e in events if e.host and e.annotation
             and e.name == progtrace.PREFIX + "k1"]
    ops = [e for e in events if not e.host and not e.annotation
           and window.start <= launched.get(e.corr, -1) <= window.end]
    kernels = [e for e in ops if "k1_bag_kernel" in e.name]
    in_span, leads = bool(kernels), []
    for k in kernels:
        holders = [s for s in spans if s.start <= launched[k.corr] <= s.end]
        in_span &= len(holders) == 1
        leads += [(k.start - s.start) * 1e-3 for s in holders]
    launch_leads = [(e.start - launched[e.corr]) * 1e-3 for e in ops]
    return {"in_span": in_span,
            "lead_us_median": statistics.median(leads) if leads else None,
            "lead_us_min": min(leads, default=None),
            "before_launch": sum(1 for x in launch_leads if x < 0),
            "ops": len(ops),
            "launch_lead_us_min": min(launch_leads, default=None),
            "after_window_us_max": max(
                ((e.end - window.end) * 1e-3 for e in ops), default=None)}


def ops_by_span(events: list[devtrace.Event], steps: int, top: int = 6
                ) -> dict:
    """Each port span's (and ``outside``'s) device operations, the
    longest first: ms a step by operation name, cut to 60 characters."""
    window, launched = _window_and_calls(events)
    index = progtrace.Innermost([e for e in events if e.host and e.annotation
                                 and e.name.startswith(progtrace.PREFIX)])
    out: dict[str, dict[str, float]] = {}
    for e in events:
        t = launched.get(e.corr)
        if e.host or e.annotation or t is None or not (
                window.start <= t <= window.end):
            continue
        ops = out.setdefault(index.at(t), {})
        ops[e.name[:60]] = ops.get(e.name[:60], 0.0) + (
            e.end - e.start) * 1e-6 / steps
    return {n: sorted(ops.items(), key=lambda kv: -kv[1])[:top]
            for n, ops in sorted(out.items())}


def reading(events: list[devtrace.Event],
            prog: progtrace.Summary | None) -> dict:
    dev = devtrace.summarize(events)
    if dev is None:
        return {"error": "no device operation in the window"}
    per_step = 1e3 / dev.steps
    window, _ = _window_and_calls(events)
    spans = sum(1 for e in events if e.host and e.annotation
                and e.name.startswith(progtrace.PREFIX)
                and window.start <= e.start <= window.end)
    out = {
        "harness": {"sparse_ms": dev.span_device_s.get("sparse", 0.0)
                    * per_step,
                    "dense_ms": dev.span_device_s.get("dense", 0.0)
                    * per_step,
                    "idle_ms": (dev.window_s - dev.busy_s) * per_step},
        "steps": dev.steps, "spans_per_step": spans / dev.steps}
    if prog is None:
        return dict(out, error="no port span in the window")
    run = types.SimpleNamespace(program=prog)
    out["metrics"] = {n: harness.metric_reader(ROOT, n)(run)
                      for n in READERS}
    out["idle_ms"] = {n: t * per_step
                      for n, t in sorted(prog.idle_by_span_s.items())}
    out["device_ms"] = {n: t * per_step
                        for n, t in sorted(prog.device_s.items())}
    out["k1"] = k1_placement(events)
    out["ops_ms"] = ops_by_span(events, dev.steps)
    return out


def main(argv: list[str]) -> int:
    kept: list[devtrace.Event] = []
    real = devtrace.events_from_profiler

    def keep(prof):
        kept[:] = real(prof)
        return kept

    devtrace.events_from_profiler = keep
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  ROOT / "bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    rc = run.main(argv + ["--trace", "1"])
    if rc != 0 or not kept:
        return rc or 1
    prog = progtrace.summarize(kept)
    print(progtrace.idle_note(prog), file=sys.stderr)
    print(json.dumps(reading(kept, prog)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
