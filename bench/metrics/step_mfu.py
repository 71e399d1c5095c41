"""step_mfu: the whole step's share of the card's peaks.  The least time
each step's work needs (its FLOPs by dtype and its bytes: ids, distinct
rows, dense features, weights read once, scores written once), summed
over the window's steps, over the traced window."""
from bench.roofline import least_time


def read(run):
    if run.trace is None or run.work is None or run.trace.window_s <= 0:
        return None
    bound = sum(least_time(run.work[j]["step"], run.peaks) for j in run.which)
    return 100.0 * bound / run.trace.window_s
