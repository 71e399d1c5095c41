"""k1_roofline: K1's share of its roofline.  The least time K1's launches
need at the card's peaks (each launch's bytes and float32 adds, as the
configuration's reference counts them from the pool batch it pooled),
summed over the window's steps, over the device time of the operations
launched inside the SparseNet span (``apply_sparse``)."""
from bench.roofline import least_time


def read(run):
    if run.trace is None or run.work is None:
        return None
    t = run.trace.span_device_s.get("sparse", 0.0)
    if t <= 0:
        return None
    bound = sum(least_time(c, run.peaks)
                for j in run.which for c in run.work[j]["k1"])
    return 100.0 * bound / t
