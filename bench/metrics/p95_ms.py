"""p95_ms: the 95th percentile of every step's latency in the window, from
the step's start to its scores on the host (host clock), linear between
order statistics."""
import statistics


def read(run):
    if run.steps < 2:
        return None
    lat = [x * 1e3 for x in run.latencies_s]
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
