"""The closed loop: one caller, steps back to back.

The pool is ``traffic["pool"]`` batches of ``traffic["batch"]`` items
drawn by ``bench.gen`` (the click log's distributions).  Step i scores
pool batch i mod pool; at most ``traffic["in_flight"]`` steps are queued
and not yet on the host.  No step starts once ``seconds`` have passed,
and the window ends when the last one's scores are on the host.  A step's
latency runs from its launch to its scores on the host.
"""
import collections
import time

from bench import gen


def draw_pool(sizes: dict, traffic: dict, seed: int, device) -> list[dict]:
    return gen.draw_pool(sizes, traffic, seed, device)


def window(launch, finish, pool: list[dict], traffic: dict,
           seconds: float) -> tuple[float, list[float]]:
    """(window s, each step's latency s)."""
    depth = traffic["in_flight"]
    lat = []
    pending = collections.deque()
    t_start = t1 = time.perf_counter()
    i = 0
    while (t1 - t_start < seconds) or pending:
        if t1 - t_start < seconds and len(pending) < depth:
            t0 = time.perf_counter()
            j = i % len(pool)
            pending.append((t0, j, launch(i, j)))
            i += 1
            continue
        t0, j, started = pending.popleft()
        finish(j, started)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
    return t1 - t_start, lat
