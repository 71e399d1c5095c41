"""Batched event-ordered serving core.

``engine._sweep`` solves the k-server earliest-free FIFO recurrence one
heap op per job — exact, but interpreter-bound at the 1e5–1e6 job counts
a full 86400 s day produces.  This module attacks that cost
**bitwise-equal to the scalar sweep**:

1.  :func:`blocked_fifo_finish` — a single-stream blocked kernel built on
    speculate-and-verify.  One structural fact makes cheap verification
    possible: in the true run the popped server-free times are
    non-decreasing and are exactly the B smallest elements of
    ``free0 ∪ ends`` (each end is pushed once, pops only grow), so the
    whole pop sequence is ``sorted(free0 ∪ ends)[:B]`` and the end state
    is the k largest.  A candidate ``ends`` vector produced any way at
    all is *the* solution iff it is consistent with its own pop sequence
    bitwise and every pop drawn from ``ends`` comes from an earlier job.
    Two regimes verify in O(B log B) with tiny constants:

    - **light** (every job finds a free server): candidate
      ``ready + dur``; for sorted arrivals and strictly positive
      durations the single check ``sorted(free0 ∪ ends)[:B] <= ready``
      certifies both consistency and availability;
    - **saturated** (no job ever finds a free server, near-constant
      durations): candidate from a round-robin column fold
      (``np.add.accumulate`` down a ``[G, k]`` duration matrix — the
      exact adds the scalar sweep performs), verified by pop
      monotonicity plus ``ready <= pops``;
    - anything else falls back to ``engine._sweep`` for that block, so
      correctness never depends on speculation succeeding.  (A general
      fixpoint iteration over the claimed pop structure was prototyped
      and measured: convergence is linear — ~50 resolved positions per
      round — because beyond-frontier structure is chaotic in busy
      regimes.  It was dropped; failed-speculation overhead is now
      ~15 ns/job against the sweep's ~250 ns/job.)

2.  :func:`fleet_fifo_finish` — the batched path.  A full-day interval
    does not produce one million-job stream; it produces hundreds of
    *independent* per-slot streams.  The recurrence is sequential per
    stream but embarrassingly parallel across streams.  Streams are
    grouped by k (pool slot groups are k-homogeneous); every group wide
    enough to pay goes to the fleet FIFO solver (K4,
    :mod:`repro_torch.kernels.fleet_fifo`): one CUDA launch for all of a
    call's wide groups on a card, its plain PyTorch version (a loop over
    time steps) on the CPU.  Narrow groups run through the scalar sweep.

Floating point (why bitwise equality is possible): the per-step min over
k server-free times is an exact associative reduction, each finish time
is one ``max`` and one ``+`` on the same operands the sweep uses, and an
``argmin`` tie picks a *slot*, never a value — the free-time multiset is
identical either way, and the end state is compared sorted.  Only the
k == 1 Lindley closed form in ``engine`` reassociates; nothing here does.

Determinism: simulated path — no RNG, no wall clocks; all state is
threaded explicitly.

This is the port's copy of the reference module.  The reference's fleet
path is a jitted ``lax.scan``; the port's is the K4 kernel (one thread a
stream, the free times sorted in registers, jobs staged through shared
memory) behind the same grouping, with ``fleet_jax`` renamed
``fleet_kernel``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.types import resolve_device
from repro_torch.kernels.fleet_fifo import ops as k4
from repro_torch.serving.engine import _sweep

_DEFAULT_BLOCK = 8192
# fleet batching only pays when the step loop advances several jobs at
# once; below this effective width the sequential sweep is already fine
_MIN_FLEET_WIDTH = 4

# per-call path mix (reset with engine.stats_reset)
stats = {
    "light": 0, "saturated": 0, "fallback": 0, "blocks": 0, "calls": 0,
    "fleet_calls": 0, "fleet_groups": 0, "fleet_jobs": 0,
    "fleet_kernel": 0, "fleet_seq": 0,
}


def stats_reset() -> None:
    for key in stats:
        stats[key] = 0


# ---------------------------------------------------------------------------
# single-stream blocked kernel
# ---------------------------------------------------------------------------

def blocked_fifo_finish(
    ready: np.ndarray, dur: np.ndarray, k: int,
    free0: np.ndarray | None = None, block: int = _DEFAULT_BLOCK,
    return_state: bool = False,
):
    """Bitwise drop-in for ``engine._sweep``: finish times of jobs served
    FIFO (array order) by the earliest-free of ``k`` servers, solved in
    blocks of ``block`` jobs with the k-vector free state carried across
    seams.  With ``return_state`` also returns the k server free times
    after the last job, sorted ascending (same as ``_sweep``'s
    ``np.sort(free)``)."""
    ready = np.ascontiguousarray(ready, dtype=np.float64)
    dur = np.ascontiguousarray(dur, dtype=np.float64)
    n = ready.shape[0]
    k = max(int(k), 1)
    h = np.zeros(k) if free0 is None else \
        np.sort(np.asarray(free0, dtype=np.float64))
    if n == 0:
        return (np.zeros(0), h) if return_state else np.zeros(0)
    stats["calls"] += 1
    block = max(int(block), 1)
    ends = np.empty(n)
    for start in range(0, n, block):
        stop = min(start + block, n)
        e_blk, h = _solve_block(ready[start:stop], dur[start:stop], h, k)
        ends[start:stop] = e_blk
    return (ends, h) if return_state else ends


def _solve_block(r, d, h, k):
    """One block against the sorted free-state ``h``; returns
    ``(ends, next_h)`` with ``next_h`` sorted ascending."""
    stats["blocks"] += 1
    B = r.shape[0]
    d_min = float(d.min())
    if d_min > 0.0 and (B == 1 or bool(np.all(r[1:] >= r[:-1]))):
        out = _try_light(r, d, h)
        if out is not None:
            stats["light"] += 1
            return out
    out = _try_saturated(r, d, h, k)
    if out is not None:
        stats["saturated"] += 1
        return out
    stats["fallback"] += 1
    return _sweep(r, d, k, free0=h, return_state=True)


def _try_light(r, d, h):
    """All-idle speculation for sorted arrivals with positive durations.

    Hypothesis: every job starts at its arrival, ``e = r + d``.  The pop
    sequence is then the B smallest of ``h ∪ e``; the hypothesis holds
    iff every pop value is ``<= r_t``.  Availability is automatic: a pop
    sourced from ``e_j`` has ``e_j <= r_t`` and ``e_j = r_j + d_j > r_j``
    (durations strictly positive), so ``r_j < r_t`` and — arrivals
    sorted — ``j < t``.  One concatenate + one sort, ~8 ns/job."""
    B = r.shape[0]
    e = r + d
    merged = np.sort(np.concatenate([h, e]))
    if not bool(np.all(merged[:B] <= r)):
        return None
    return e, merged[B:].copy()


def _try_saturated(r, d, h, k):
    """Round-robin speculation for the always-busy regime.

    Hypothesis: no job ever finds a free server, so job ``t`` pops the
    end of job ``t - k`` on the same "column" (or ``h_sorted[t]`` for the
    first k) and ``e_t = pop_t + d_t``.  Column ends are one
    ``np.add.accumulate`` down a ``[G, k]`` duration matrix — the exact
    adds the scalar sweep performs.  Sufficient check: the claimed pop
    sequence (extended k-1 steps past the block, i.e. each column's
    next pop) is non-decreasing — then the heap at step t is exactly the
    next k claimed pops and its min is pop_t — and ``r <= pops`` so no
    job is idle.  The k pops just past the block are the end state.
    Holds for near-constant durations under overload; mixed durations
    unbalance the columns and the check rejects."""
    B = r.shape[0]
    G = -(-B // k)
    pad = G * k - B
    D = d if pad == 0 else np.concatenate([d, np.zeros(pad)])
    E = np.add.accumulate(np.vstack([h, D.reshape(G, k)]), axis=0)
    pops = E[:-1].ravel()
    p = pops[:B]
    if not np.all(r <= p):
        return None
    rem = B % k
    tail = E[-1] if rem == 0 else E[-1, :rem]
    q = np.concatenate([pops, tail])          # claimed pops 0 .. B+k-1
    qq = q[:B + k - 1]
    if not np.all(qq[1:] >= qq[:-1]):
        return None
    e = E[1:].ravel()[:B]
    return e, np.sort(q[B:B + k])


# ---------------------------------------------------------------------------
# fleet path — S independent streams through the fleet FIFO solver (K4)
# ---------------------------------------------------------------------------

def fleet_fifo_finish(streams, device: str | torch.device = "cuda"):
    """Solve many independent k-server FIFO streams at once.

    ``streams`` is a sequence of ``(ready, dur, k)`` or
    ``(ready, dur, k, free0)`` tuples — one per pool slot.  Returns a
    list of ``(ends, state)`` pairs aligned with the input, each
    bitwise-equal to ``engine._sweep(ready, dur, k, free0,
    return_state=True)``.

    Streams are grouped by ``k``.  A group whose jobs per step (total
    jobs over its longest stream) reach ``_MIN_FLEET_WIDTH`` is wide: all
    wide groups of the call go to :func:`kernels.fleet_fifo.fleet_fifo`
    together, on ``device`` (the CUDA kernel on ``"cuda"``, its plain
    version on ``"cpu"``).  Narrow groups run sequentially through the
    scalar sweep.
    """
    dev = resolve_device(device)
    items = []
    for s in streams:
        r, d, k = s[0], s[1], int(s[2])
        f0 = s[3] if len(s) > 3 else None
        items.append((np.ascontiguousarray(r, dtype=np.float64),
                      np.ascontiguousarray(d, dtype=np.float64),
                      max(k, 1),
                      None if f0 is None else
                      np.asarray(f0, dtype=np.float64)))
    out: list = [None] * len(items)
    if not items:
        return out
    stats["fleet_calls"] += 1
    stats["fleet_jobs"] += sum(it[0].shape[0] for it in items)

    by_k: dict[int, list[int]] = {}
    for i, it in enumerate(items):
        by_k.setdefault(it[2], []).append(i)

    wide: list[int] = []
    for k, idxs in sorted(by_k.items()):
        ns = [items[i][0].shape[0] for i in idxs]
        n_max = max(ns)
        # effective width: jobs advanced per step across the group
        if n_max > 0 and sum(ns) / n_max >= _MIN_FLEET_WIDTH:
            stats["fleet_groups"] += 1
            stats["fleet_kernel"] += len(idxs)
            wide.extend(idxs)
        else:
            stats["fleet_seq"] += len(idxs)
            for i in idxs:
                r, d, kk, f0 = items[i]
                out[i] = _sweep(r, d, kk, free0=f0, return_state=True)
    if wide:
        _run_fleet(items, wide, out, dev)
    return out


def _run_fleet(items, idxs, out, dev):
    """The wide streams ``idxs`` through one K4 call
    (``k4.fleet_fifo_streams``: the kernel on a CUDA device, its plain
    version on the CPU), packed once into the ragged layout; the state rows
    come back sorted."""
    ks = [items[i][2] for i in idxs]
    ends, state, offsets = k4.fleet_fifo_streams(
        [items[i][0] for i in idxs], [items[i][1] for i in idxs], ks,
        [items[i][3] for i in idxs], dev)
    for j, i in enumerate(idxs):
        out[i] = (ends[offsets[j]:offsets[j + 1]], state[j, :ks[j]])


def merge_event_streams(*streams: np.ndarray):
    """Stable event-ordered merge of per-source time arrays.

    Returns ``(times, order)`` where ``order`` indexes the concatenation
    of the inputs and ``times = concat(streams)[order]`` is sorted
    ascending with ties broken by source order then in-source order —
    the deterministic tie-break the runtime's hedge-admission pass
    relies on (primaries before duplicates at equal timestamps)."""
    cat = np.concatenate([np.asarray(s, dtype=np.float64) for s in streams])
    order = np.argsort(cat, kind="stable")
    return cat[order], order
