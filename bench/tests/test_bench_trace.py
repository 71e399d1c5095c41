"""The device trace's reduction, and the per-layer readers over it, on
events made by hand."""
import pytest

from bench import devtrace, harness
from bench.devtrace import Event


def _ev(name, start, end, corr=0, host=True, annotation=False):
    return Event(name=name, start=start, end=end, corr=corr, host=host,
                 annotation=annotation)


def _step_events(t, corr):
    """One step from host time t: spans, runtime launches, device ops."""
    return [
        _ev("bench.step", t, t + 100, annotation=True),
        _ev("bench.sparse", t + 5, t + 40, annotation=True),
        _ev("bench.dense", t + 40, t + 80, annotation=True),
        _ev("bench.d2h", t + 80, t + 100, annotation=True),
        # a torch op whose own id collides with a launch's: not a launch
        _ev("aten::mm", t + 90, t + 91, corr=corr + 1),
        _ev("cudaLaunchKernel", t + 10, t + 12, corr=corr),
        _ev("cudaLaunchKernel", t + 45, t + 47, corr=corr + 1),
        _ev("cudaMemcpyAsync", t + 85, t + 86, corr=corr + 2),
        _ev("k1_bag_kernel", t + 20, t + 50, corr=corr, host=False),
        _ev("gemm", t + 50, t + 70, corr=corr + 1, host=False),
        _ev("Memcpy DtoH", t + 90, t + 95, corr=corr + 2, host=False),
        _ev("bench.step", t + 2, t + 99, host=False, annotation=True),
    ]


def _window(t0, t1):
    return [_ev("bench.window", t0, t1, annotation=True)]


def test_attribution_busy_and_gaps():
    s = devtrace.summarize(_window(0, 200) + _step_events(0, 11)
                           + _step_events(100, 21))
    assert s.steps == 2
    assert s.window_s == pytest.approx(200e-9)
    assert s.busy_s == pytest.approx(2 * 55e-9)
    assert s.span_device_s == pytest.approx(
        {"sparse": 60e-9, "dense": 40e-9, "d2h": 10e-9})
    assert dict(s.device_ops)["k1_bag_kernel"] == pytest.approx(60e-9)
    # gaps: [0, 20) in step, [70, 90) in dense, [95, 120) in d2h, ...
    gaps = sorted((n, round(g * 1e9)) for n, g in s.idle_gaps)
    assert gaps == [("d2h", 5), ("d2h", 25), ("dense", 20), ("dense", 20),
                    ("step", 20)]


def test_no_device_operation_no_summary():
    evs = [e for e in _window(0, 100) + _step_events(0, 11) if e.host]
    assert devtrace.summarize(evs) is None
    assert devtrace.summarize(_step_events(0, 11)) is None     # no window


def _run(trace, work):
    cell = harness.Cell(name="c", sizes={}, traffic={}, e2e=[],
                        per_layer=[], root=harness.ROOT)
    return harness.Run(cell=cell, setup_s=3.0,
                       window_s=2.0, latencies_s=[0.5, 0.5, 1.0],
                       which=[0, 1, 0], pool_items=[10, 20],
                       peaks={"flops": {"float32": 1e3},
                              "bytes_per_s": 1e2},
                       work=work, trace=trace)


def test_readers():
    trace = devtrace.Summary(window_s=2.0, busy_s=1.5,
                             span_device_s={"sparse": 0.5, "dense": 0.6},
                             device_ops=[], idle_gaps=[],
                             steps=3)
    work = [{"k1": [{"bytes": 10, "flops": {"float32": 0}}],
             "step": {"bytes": 20, "flops": {"float32": 100}}},
            {"k1": [{"bytes": 5, "flops": {"float32": 0}},
                    {"bytes": 5, "flops": {"float32": 0}}],
             "step": {"bytes": 0, "flops": {"float32": 300}}}]
    run = _run(trace, work)
    read = {n: harness.metric_reader(harness.ROOT, n)(run) for n in (
        "k1_roofline.tput", "dense_ms.tput", "step_mfu.tail",
        "idle_share.tput", "items_per_s", "p95_ms", "setup_s")}
    # K1: 0.1 + 0.1 + 0.1 s of bound over 0.5 s under apply_sparse
    assert read["k1_roofline.tput"] == pytest.approx(60.0)
    assert read["dense_ms.tput"] == pytest.approx(200.0)
    # step: 0.2 + 0.3 + 0.2 s of bound over the 2 s window
    assert read["step_mfu.tail"] == pytest.approx(35.0)
    assert read["idle_share.tput"] == pytest.approx(25.0)
    # 10 + 20 + 10 items over the 2 s window
    assert read["items_per_s"] == pytest.approx(20.0)
    assert read["p95_ms"] == pytest.approx(950.0)
    assert read["setup_s"] == 3.0


def test_untraced_readers_give_nothing():
    run = _run(None, None)
    for n in ("k1_roofline.tail", "dense_ms.tail", "step_mfu.tput",
              "idle_share.tail"):
        assert harness.metric_reader(harness.ROOT, n)(run) is None
