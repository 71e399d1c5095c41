"""The reduction of the port's own spans (``bench/progtrace.py``) and the
readers over it: on events made by hand, on a CPU run, and on the card
(``-m cuda``), where the port's spans and the harness's share the
profiler's clock."""
import types

import pytest

from bench import devtrace, harness, progtrace
from bench.devtrace import Event
from bench.tests.util import small_cell

READERS = ("k1_ms", "mlp_ms", "dense_self_ms", "program_idle_ms")


def _ev(name, start, end, corr=0, host=True, annotation=False):
    return Event(name=name, start=start, end=end, corr=corr, host=host,
                 annotation=annotation)


def _span(name, start, end):
    return _ev(name, start, end, annotation=True)


def _launch(t, corr, op, a, b):
    """A runtime call at host time t and the device operation it put on
    the card over [a, b)."""
    return [_ev("cudaLaunchKernel", t, t + 1, corr=corr),
            _ev(op, a, b, corr=corr, host=False)]


def _step(t, corr):
    """One step from host time t, the harness's spans around the port's:
    step > model > (sparse > k1), (dense > mlp, mlp); d2h after."""
    return [
        _span("bench.step", t, t + 100),
        _span("repro_torch.model", t + 2, t + 80),
        _span("bench.sparse", t + 4, t + 30),
        _span("repro_torch.sparse", t + 5, t + 29),
        _span("repro_torch.k1", t + 8, t + 20),
        _span("bench.dense", t + 30, t + 78),
        _span("repro_torch.dense", t + 31, t + 77),
        _span("repro_torch.mlp", t + 35, t + 45),
        _span("repro_torch.mlp", t + 60, t + 70),
        _span("bench.d2h", t + 80, t + 100),
        # the spans' GPU-side mirrors: never read
        _ev("repro_torch.k1", t + 10, t + 95, host=False, annotation=True),
        _ev("repro_torch.dense", t + 10, t + 95, host=False,
            annotation=True),
        *_launch(t + 10, corr, "k1_bag_kernel", t + 12, t + 40),
        *_launch(t + 40, corr + 1, "gemm", t + 40, t + 50),
        *_launch(t + 50, corr + 2, "cat", t + 50, t + 55),
        *_launch(t + 65, corr + 3, "gemm", t + 65, t + 75),
        # the scores' copy, launched by the harness outside the port
        _ev("cudaMemcpyAsync", t + 85, t + 86, corr=corr + 4),
        _ev("Memcpy DtoH", t + 86, t + 90, corr=corr + 4, host=False),
    ]


def _window(t0, t1):
    return [_span("bench.window", t0, t1)]


def _events():
    return _window(0, 200) + _step(0, 10) + _step(100, 20)


def test_self_time_by_innermost_port_span():
    s = progtrace.summarize(_events())
    assert s.steps == 2
    assert s.device_s == pytest.approx(
        {"k1": 56e-9, "mlp": 40e-9, "dense": 10e-9, "outside": 8e-9})


def test_idle_split_over_each_gap():
    s = progtrace.summarize(_events())
    # the gaps: [0, 12) outside 2, model 3, sparse 3, k1 4; [55, 65) dense
    # 5, mlp 5; [75, 86) dense 2, model 3, outside 6; [90, 112) outside 12,
    # then as [0, 12); [155, 165) and [175, 186) as before; [190, 200)
    # outside 10
    got = {k: round(v * 1e9) for k, v in s.idle_by_span_s.items()}
    assert got == {"outside": 2 + 6 + 12 + 6 + 10, "model": 3 + 3 + 3 + 3,
                   "sparse": 3 + 3, "k1": 4 + 4, "dense": 5 + 2 + 5 + 2,
                   "mlp": 5 + 5}
    idle = sum(s.idle_by_span_s.values())
    d = devtrace.summarize(_events())
    assert idle == pytest.approx(d.window_s - d.busy_s)


def test_a_gap_from_d2h_into_k1_is_split_by_time():
    evs = (_window(0, 100)
           + [_span("bench.step", 0, 100), _span("bench.d2h", 0, 30),
              _span("repro_torch.model", 40, 90),
              _span("repro_torch.sparse", 45, 80),
              _span("repro_torch.k1", 50, 70)]
           + _launch(60, 1, "k1_bag_kernel", 70, 100))
    s = progtrace.summarize(evs)
    got = {k: round(v * 1e9) for k, v in s.idle_by_span_s.items()}
    assert got == {"outside": 40, "model": 5, "sparse": 5, "k1": 20}
    # the harness's reduction names the whole gap by where it began
    assert devtrace.summarize(evs).idle_gaps == [("d2h", pytest.approx(
        70e-9))]
    assert s.device_s == pytest.approx({"k1": 30e-9})


def test_nesting_deeper_than_devtraces_look_back():
    depth = 40
    spans = [_span(f"repro_torch.l{i}", i, 1000 - i) for i in range(depth)]
    # many short closed spans inside the innermost, before the launch
    spans += [_span("repro_torch.mlp", 100 + 10 * i, 105 + 10 * i)
              for i in range(30)]
    evs = (_window(0, 1000) + [_span("bench.step", 0, 1000)] + spans
           + _launch(500, 7, "gemm", 600, 1000))
    s = progtrace.summarize(evs)
    assert s.device_s == pytest.approx({f"l{depth - 1}": 400e-9})
    assert s.idle_by_span_s["mlp"] == pytest.approx(150e-9)


def test_gpu_mirrors_and_other_annotations_are_not_spans():
    evs = _events() + [
        _ev("repro_torch.mlp", 0, 200, host=False, annotation=True),
        _span("aten::mm", 0, 200)]
    assert progtrace.summarize(evs) == progtrace.summarize(_events())


def test_no_port_span_no_summary():
    bench_only = [e for e in _events()
                  if not e.name.startswith(progtrace.PREFIX)]
    assert progtrace.summarize(bench_only) is None
    assert progtrace.summarize(_step(0, 10)) is None           # no window
    assert progtrace.summarize(
        [e for e in _events() if e.host]) is None              # no op


def test_devtraces_summary_unchanged_by_the_port_spans():
    bench_only = [e for e in _events()
                  if not e.name.startswith(progtrace.PREFIX)]
    assert devtrace.summarize(_events()) == devtrace.summarize(bench_only)


def test_prefix_is_the_ports():
    from repro_torch.common import trace

    assert progtrace.PREFIX == trace.PREFIX


def _run(program):
    cell = harness.Cell(name="c", sizes={}, traffic={}, e2e=[],
                        per_layer=[], root=harness.ROOT)
    run = harness.Run(cell=cell, setup_s=1.0, window_s=2.0,
                      latencies_s=[0.5], which=[0], pool_items=[10],
                      peaks={})
    run.program = program
    return run


def _read(run, name):
    return harness.metric_reader(harness.ROOT, name)(run)


@pytest.mark.parametrize("variant", ["tput", "tail"])
def test_readers(variant):
    s = progtrace.Summary(
        device_s={"k1": 0.8, "mlp": 0.4, "dense": 0.2, "outside": 0.1},
        idle_by_span_s={"model": 0.01, "k1": 0.03, "outside": 0.5},
        steps=4)
    read = {n: _read(_run(s), f"{n}.{variant}") for n in READERS}
    assert read == pytest.approx({"k1_ms": 200.0, "mlp_ms": 100.0,
                                  "dense_self_ms": 50.0,
                                  "program_idle_ms": 10.0})


def test_readers_without_the_port_spans():
    for n in READERS:
        assert _read(_run(None), n) is None
        run = _run(None)
        del run.program
        assert _read(run, n) is None
    empty = progtrace.Summary(device_s={"outside": 1.0}, idle_by_span_s={},
                              steps=2)
    assert [_read(_run(empty), n) for n in READERS] == [None, None, None,
                                                        0.0]


def test_idle_note():
    s = progtrace.summarize(_events())
    note = progtrace.idle_note(s)
    assert note.startswith("program idle_ms a step model ")
    assert " k1 0.000004 " in note and note.endswith("outside 0.000018")
    assert "no port span" in progtrace.idle_note(None)


def _kept_events(monkeypatch) -> list:
    """The events the harness's traced run reduces, kept for a second
    reduction."""
    kept = []
    real = devtrace.events_from_profiler

    def keep(prof):
        kept[:] = real(prof)
        return kept

    monkeypatch.setattr(devtrace, "events_from_profiler", keep)
    return kept


def test_a_cpu_run_carries_the_port_spans(cpu, monkeypatch):
    """On the CPU the profiler records the port's spans and the harness's,
    but no device operation: nothing to attribute."""
    kept = _kept_events(monkeypatch)
    out = harness.run_cell(small_cell("mtwnd.bulk"), 9, 0.05, True, cpu)
    assert out["correct"]
    names = {e.name for e in kept if e.annotation}
    assert {"repro_torch." + n for n in ("model", "sparse", "k1", "dense",
                                         "mlp")} <= names
    assert progtrace.summarize(kept) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rm2.bulk", "mtwnd.bulk", "rm2.retrieval"])
def test_port_spans_on_the_card(name, cuda_device, monkeypatch):
    kept = _kept_events(monkeypatch)
    out = harness.run_cell(small_cell(name, batch=8192), 31, 1.0, True,
                           cuda_device)
    assert out["correct"], out["checks"]
    prog, dev = progtrace.summarize(kept), devtrace.summarize(kept)
    m = {n: _read(types.SimpleNamespace(program=prog), n) for n in READERS}
    assert m["program_idle_ms"] >= 0
    assert all(m[n] > 0 for n in READERS[:3]), m
    per_step = 1e3 / dev.steps
    assert m["k1_ms"] == pytest.approx(
        dev.span_device_s["sparse"] * per_step, rel=1e-3)
    assert m["mlp_ms"] + m["dense_self_ms"] == pytest.approx(
        dev.span_device_s["dense"] * per_step, rel=1e-3)
    assert m["program_idle_ms"] <= (dev.window_s - dev.busy_s) * per_step, (
        m, dev.window_s, dev.busy_s)
    # every K1 kernel was launched inside exactly one K1 span: the
    # correlation, on the host's clock alone.  Where the kernel ran is not
    # held to the host's spans: the profiler maps the card's times onto
    # the host's clock with errors of milliseconds in stretches (a kernel
    # read 3.85 ms before its own launch, another 0.24 ms after the window
    # that waited for it); tools/port_spans.py measures them
    k1_spans = [e for e in kept if e.host and e.annotation
                and e.name == "repro_torch.k1"]
    (window,) = [e for e in kept if e.host and e.annotation
                 and e.name == "bench.window"]
    launched = {e.corr: e.start for e in kept
                if e.host and not e.annotation and e.name.startswith("cu")}
    kernels = [e for e in kept if not e.host and not e.annotation
               and "k1_bag_kernel" in e.name
               and window.start <= launched.get(e.corr, -1) <= window.end]
    assert kernels
    for k in kernels:
        holders = [s for s in k1_spans
                   if s.start <= launched[k.corr] <= s.end]
        assert len(holders) == 1, (k, launched[k.corr], holders)
