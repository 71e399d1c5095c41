"""dense_ms: device milliseconds a step of the operations launched inside
the DenseNet span (``apply_dense_given_pooled``)."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    t = run.trace.span_device_s.get("dense", 0.0)
    return 1e3 * t / run.trace.steps if t > 0 else None
