"""The least time a piece of work needs on the card: the larger of its
FLOPs over the peak of the dtype they run in (summed over dtypes) and its
bytes over the peak bandwidth (``bench/peaks.json``)."""
from __future__ import annotations


def least_time(work: dict, peaks: dict) -> float:
    """Seconds; ``work`` is ``{"bytes": n, "flops": {dtype: n}}``."""
    compute = sum(n / peaks["flops"][dtype]
                  for dtype, n in work["flops"].items())
    return max(compute, work["bytes"] / peaks["bytes_per_s"])
