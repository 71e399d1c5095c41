"""k-server FIFO queueing engine — the simulator's hot core.

Every pool in the serving simulator (CPU thread pools, the S-D sparse and
dense pools, the accelerator host pool) is the same discrete-event object:
jobs processed FIFO *in a given order*, each job taken by the earliest-free
of ``k`` identical servers (the Kiefer-Wolfowitz recurrence).  A first
implementation interleaved that recurrence with per-job NumPy indexing,
dict lookups and byte accounting, which made offline profiling
interpreter-bound.  This module isolates the recurrence so everything
around it (query splitting, duration tables, fusion grouping, utilization
accounting, per-query finish reduction) becomes NumPy array sweeps in
``simulator.py``, and solves the recurrence itself in closed form where an
exact vectorization exists:

- ``k == 1``: the Lindley recurrence ``e_j = max(ready_j, e_{j-1}) + dur_j``
  unrolls to ``e_j = T_j + max_{l<=j}(ready_l - T_{l-1})`` with
  ``T = cumsum(dur)`` — one ``cumsum`` plus one ``maximum.accumulate``.  A
  carried prefix (the server still busy from an earlier window) enters the
  closed form as ``e_{-1} = f0``, i.e. the first accumulate term becomes
  ``max(ready_0, f0)`` — continuous-time windows cost one extra ``max``.
- ``k >= n``: every job finds an idle server — ``max(ready, 0) + dur``.
- otherwise: a minimal-overhead scalar sweep over pre-extracted float lists
  (``heapreplace`` on a k-element heap).  The general earliest-free
  recurrence is inherently sequential — each pop depends on the running
  order statistics of all earlier ends — so the fast path wins by stripping
  the per-job Python/NumPy overhead, not by pretending the data dependence
  away.  (An exact "assignment relaxation" vectorization was prototyped and
  measured: it converges only in light traffic and loses 10x under the
  overloaded probes the throughput bisection must evaluate, so it was
  dropped.)  Large ``k > 1`` streams (``n >= 4096``) dispatch to the
  ``event_core`` blocked kernel instead: bitwise-equal
  speculate-and-verify blocks that win outright in light/constant-
  duration regimes and cost a few percent when every block falls back
  to this sweep; batches of *independent* streams should use
  ``event_core.fleet_fifo_finish``.

Floating point: the Lindley transform reassociates max/plus, so k == 1
fast-path finish times can differ from the reference loop by accumulated
rounding (~1e-12 relative); equivalence tests use tight tolerances rather
than bitwise equality.  The k > 1 sweep performs the identical operations
as the reference and is bitwise-exact.
"""
from __future__ import annotations

import heapq
import sys

import numpy as np

# introspection counters (benchmarks report path mix; "blocked" counts
# dispatches to the event_core blocked kernel)
stats = {"lindley": 0, "idle": 0, "sweep": 0, "reference": 0, "blocked": 0}

# auto-dispatch threshold: below this the blocked kernel's speculation
# setup cannot win over the plain sweep even when a path hits
_BLOCKED_MIN_N = 4096


def stats_reset() -> None:
    """Reset the path-mix counters (and the event core's, if loaded).

    Benchmarks report the mix per-bench and tests assert on it, so a
    shared global counter must be resettable — the port's schedule tests
    call this around every test."""
    for key in stats:
        stats[key] = 0
    ec = sys.modules.get("repro_torch.serving.event_core")
    if ec is not None:
        ec.stats_reset()


def _event_core():
    """Lazy import: event_core imports ``_sweep`` from this module, so
    the dependency must not be circular at import time."""
    from repro_torch.serving import event_core
    return event_core


def fifo_finish(
    ready: np.ndarray, dur: np.ndarray, k: int, slow: bool = False,
    free0: np.ndarray | None = None, blocked: bool | None = None,
) -> np.ndarray:
    """Finish times of jobs processed FIFO (in array order) by ``k``
    identical servers, each job taken by the earliest-free server.

    ``ready`` need not be sorted: the j-th job enters service at
    ``max(ready_j, pop_j)`` where pops are handed out in array order —
    exactly the semantics of the reference ``heapq`` loop.

    ``free0`` (length ``k``) seeds the servers' initial free times — the
    carried backlog of an earlier window.  ``None`` keeps the historical
    idle-pool start (all zeros) and its fast paths bit-for-bit.

    ``blocked=True`` forces the event-core blocked kernel for ``k > 1``
    (bitwise-equal to the sweep, see ``event_core``); ``None`` lets the
    dispatcher pick it automatically for large streams, where its
    speculation paths win in light/constant-duration regimes and its
    failed-speculation overhead is a few percent otherwise.
    """
    ready = np.asarray(ready, dtype=np.float64)
    dur = np.asarray(dur, dtype=np.float64)
    n = ready.shape[0]
    if n == 0:
        return np.zeros(0)
    k = max(int(k), 1)
    if slow:
        stats["reference"] += 1
        return _sweep(ready, dur, k, free0)
    if k == 1:
        stats["lindley"] += 1
        f0 = 0.0 if free0 is None else float(np.max(free0, initial=0.0))
        return _lindley(ready, dur, f0)
    if k >= n and (free0 is None or
                   float(free0.max()) <= float(ready.min())):
        # every job gets a server that is free by its arrival
        stats["idle"] += 1
        if free0 is None:
            return np.maximum(ready, 0.0) + dur
        return ready + dur
    if blocked or (blocked is None and n >= _BLOCKED_MIN_N):
        stats["blocked"] += 1
        return _event_core().blocked_fifo_finish(ready, dur, k, free0=free0)
    stats["sweep"] += 1
    return _sweep(ready, dur, k, free0)


def fifo_finish_state(
    ready: np.ndarray, dur: np.ndarray, k: int,
    free0: np.ndarray | None = None, blocked: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """:func:`fifo_finish` plus the pool's end state — the ``k`` server
    free times after the last job, sorted ascending.  This is what a
    continuous-time caller carries into the next window as ``free0``.

    Finish times are identical to ``fifo_finish``: the ``k == 1`` closed
    form is shared, and the ``k >= n`` shortcut applies whenever every
    server is free by the first arrival — pops then consume the ``n``
    smallest initial free times and every job starts at its arrival, so
    both the ends and the end state are exact array expressions.
    """
    ready = np.asarray(ready, dtype=np.float64)
    dur = np.asarray(dur, dtype=np.float64)
    k = max(int(k), 1)
    if free0 is None:
        free0 = np.zeros(k)
    free0 = np.asarray(free0, dtype=np.float64)
    if ready.shape[0] == 0:
        return np.zeros(0), np.sort(free0)
    if k == 1:
        stats["lindley"] += 1
        ends = _lindley(ready, dur, float(np.max(free0, initial=0.0)))
        return ends, ends[-1:].copy()
    if k >= len(ready) and float(free0.max()) <= float(ready.min()):
        stats["idle"] += 1
        ends = np.maximum(ready, 0.0) + dur if not free0.any() else \
            ready + dur
        state = np.sort(np.concatenate([np.sort(free0)[len(ready):], ends]))
        return ends, state
    if blocked or (blocked is None and len(ready) >= _BLOCKED_MIN_N):
        stats["blocked"] += 1
        return _event_core().blocked_fifo_finish(
            ready, dur, k, free0=free0, return_state=True)
    stats["sweep"] += 1
    return _sweep(ready, dur, k, free0, return_state=True)


def _sweep(ready: np.ndarray, dur: np.ndarray, k: int,
           free0: np.ndarray | None = None, return_state: bool = False):
    """Earliest-free k-server FIFO, one heap op per job and nothing else."""
    free = [0.0] * k if free0 is None else \
        np.asarray(free0, dtype=np.float64).tolist()
    heapq.heapify(free)
    replace = heapq.heapreplace
    ends: list[float] = []
    append = ends.append
    for a, t in zip(ready.tolist(), dur.tolist()):
        f = free[0]
        e = (a if a > f else f) + t
        append(e)
        replace(free, e)
    if return_state:
        return np.asarray(ends), np.sort(free)
    return np.asarray(ends)


def _lindley(ready: np.ndarray, dur: np.ndarray, f0: float = 0.0) -> np.ndarray:
    """Exact single-server FIFO via the unrolled Lindley recurrence,
    extended to a carried prefix: ``f0`` is the server's free time before
    the first job (``e_{-1}``), so the first accumulate term is
    ``max(ready_0, f0)``."""
    T = np.cumsum(dur)
    adj = ready - (T - dur)
    if f0 > adj[0]:
        adj = adj.copy()
        adj[0] = f0
    return T + np.maximum.accumulate(adj)
