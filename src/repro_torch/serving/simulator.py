"""Discrete-event single-server serving simulator.

Models one server executing one recommendation workload under a partition
placement and a scheduling configuration, with the paper's arrival process:
Poisson query arrivals, heavy-tailed query sizes (Fig. 2b). It reproduces
the mechanisms the paper measures:

- CPU pools: ``m`` inference threads × ``o`` operator workers; big queries
  split into sub-queries of <= d items distributed over threads
  (DeepRecSys-style data parallelism); memory-bandwidth contention across
  co-located threads.
- S-D pipeline (cpu_sd): sparse pool -> intermediate queue -> dense pool.
- Accelerator: co-located inference threads (<= max m in flight) pipelining
  through two serialized resources — host link (data loading; the paper's
  Fig. 7 bottleneck) and engine (kernels) — with query fusion up to d items
  per launch. Host-side stage (cold-psum / SparseNet) runs on a host pool.

Outputs: achieved QPS, latency percentiles, component utilizations, and
average/provisioned power via the PowerModel.

Execution engines
-----------------
Every entry point takes ``engine="fast" | "reference" | "event"``:

- ``fast`` (default): array-sweep pipeline — queries are split, mapped to
  duration/byte tables, and reduced back to per-query finish times with
  NumPy; the k-server FIFO recurrence itself runs in
  :mod:`repro_torch.serving.engine`.  Finish times match the reference within
  floating-point reassociation (~1e-12 relative).
- ``reference``: the original per-sub-query ``heapq`` loops, retained
  verbatim as the ground truth for equivalence tests and as the "before"
  engine in ``benchmarks/bench_gradient_search.py``.
- ``event``: the fast pipeline with every k > 1 pool routed through the
  blocked event core (:mod:`repro_torch.serving.event_core`) regardless of
  stream length — bitwise-identical to ``fast`` (the blocked kernel is
  bitwise-equal to the sweep it replaces), it simply forces the new
  path where ``fast`` would auto-dispatch only above a size threshold.

Rate sweeps share work through :class:`SimCache`: the Poisson gap stream is
drawn once at unit rate and rescaled (``exponential(1/r, n)`` is bitwise
``unit_gaps[:n] / r`` for NumPy Generators), the query-size resample is a
prefix of one seed-fixed stream, and splits/duration tables depend only on
the batch size — so every bisection probe of ``max_sustainable_qps`` and
every configuration of a search reuses the same arrays (common random
numbers, which also makes the p95-vs-rate curve monotone in practice).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.devices import DeviceProfile
from repro_torch.core.partition import Placement
from repro_torch.core.perfmodel import (
    PowerModel,
    accel_engine_time,
    accel_link_time,
    cpu_stage_time,
)
from repro_torch.serving.engine import fifo_finish

# Probe sizing for latency-bounded-throughput measurements: span >= ~20 SLA
# windows of queries, floored/capped for statistical quality vs runtime.
_PROBE_FLOOR = 200
_PROBE_CAP = 6000
_FUSE_WINDOW_S = 0.002  # fuse only sub-queries within 2 ms of the group head


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """One point in the parallelism space P(M+D+O)."""

    batch: int          # d: sub-query size (CPU) / fused launch size (accel)
    m: int              # model-parallelism: CPU threads or accel co-location
    o: int = 1          # op-parallelism: operator workers per CPU thread
    sd_sparse: int = 0  # cpu_sd: threads in the sparse pool (o workers each)
    fuse: bool = True   # accel query fusion (False = DeepRecSys/Baymax mode)


@dataclasses.dataclass
class SimResult:
    qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    avg_power_w: float
    utils: dict
    n_queries: int

    def meets(self, sla_ms: float, power_budget_w: float | None = None) -> bool:
        ok = self.p95_ms <= sla_ms
        if power_budget_w is not None:
            ok = ok and self.avg_power_w <= power_budget_w
        return ok


class _Pool:
    """k-server FIFO resource; returns per-job start times (reference path)."""

    def __init__(self, k: int):
        self.free_at = [0.0] * max(k, 1)

    def schedule(self, ready: float, duration: float) -> tuple[float, float]:
        start, end, _ = self.schedule_idx(ready, duration)
        return start, end

    def schedule_idx(self, ready: float, duration: float) -> tuple[float, float, int]:
        i = int(np.argmin(self.free_at))
        start = max(ready, self.free_at[i])
        self.free_at[i] = start + duration
        return start, start + duration, i

    @property
    def busy_until(self) -> float:
        return max(self.free_at)


def _split_queries(sizes: np.ndarray, arrivals: np.ndarray, d: int):
    """Split each query into sub-batches of <= d items (vectorized).

    Zero-size queries yield no sub-queries (the caller reports them as
    finishing at their arrival); without the ``nz`` mask their remainder
    write would corrupt the preceding query's last sub-batch.

    Returns (sub_arrival, sub_size, query_id) arrays."""
    sizes = np.maximum(np.asarray(sizes).astype(np.int64), 0)
    n_sub = -(-sizes // d)  # ceil
    qid = np.repeat(np.arange(len(sizes)), n_sub)
    sub_a = arrivals[qid]
    sub_s = np.full(len(qid), d, np.int64)
    nz = n_sub > 0
    last = (np.cumsum(n_sub) - 1)[nz]
    sub_s[last] = (sizes - (n_sub - 1) * d)[nz]
    return sub_a, sub_s, qid


# ---------------------------------------------------------------------------
# shared precomputation (CRN probe streams + split/duration/byte tables)
# ---------------------------------------------------------------------------


class _SizeTables:
    """Splits and service-time/byte tables for one concrete query-size
    array.  Sub-query splits are per-query independent, so a probe over the
    first ``n`` queries uses prefixes of the full arrays.  One instance is
    bound to one device (service times are device-dependent)."""

    def __init__(self, sizes: np.ndarray):
        self.sizes = np.maximum(np.asarray(sizes).astype(np.int64), 0)
        self._splits: dict[int, dict] = {}
        self._cpu_t: dict[tuple, dict[int, float]] = {}
        self._cpu_vec: dict[tuple, np.ndarray] = {}
        self._bytes_vec: dict[tuple, np.ndarray] = {}
        self._scalar: dict[tuple, dict[int, float]] = {}

    def split(self, d: int) -> dict:
        sp = self._splits.get(d)
        if sp is None:
            sizes = self.sizes
            n_sub = -(-sizes // d)
            offsets = np.concatenate([[0], np.cumsum(n_sub)])
            qid = np.repeat(np.arange(len(sizes)), n_sub)
            sub_s = np.full(len(qid), d, np.int64)
            nz = n_sub > 0
            sub_s[(offsets[1:] - 1)[nz]] = (sizes - (n_sub - 1) * d)[nz]
            uniq, inv = np.unique(sub_s, return_inverse=True)
            sp = dict(qid=qid, sub_s=sub_s, offsets=offsets, uniq=uniq, inv=inv)
            self._splits[d] = sp
        return sp

    def cpu_durations(self, ops, workers: int, active: int, d: int,
                      device: DeviceProfile) -> np.ndarray:
        """Service seconds aligned with split(d)['uniq']."""
        vkey = (ops, workers, active, d, device.name)
        vec = self._cpu_vec.get(vkey)
        if vec is None:
            tab = self._cpu_t.setdefault((ops, workers, active, device.name), {})
            uniq = self.split(d)["uniq"]
            vec = np.empty(len(uniq))
            for i, b in enumerate(uniq.tolist()):
                t = tab.get(b)
                if t is None:
                    t = tab[b] = cpu_stage_time(ops, b, workers, device, active)
                vec[i] = t
            self._cpu_vec[vkey] = vec
        return vec

    def op_bytes(self, ops, d: int) -> np.ndarray:
        """Memory traffic per sub-batch aligned with split(d)['uniq']."""
        key = (ops, d)
        vec = self._bytes_vec.get(key)
        if vec is None:
            uniq = self.split(d)["uniq"]
            vec = np.array([_items_bytes(ops, int(b)) for b in uniq])
            self._bytes_vec[key] = vec
        return vec

    def scalar(self, key: tuple) -> dict[int, float]:
        """Persistent {batch: value} memo (accel fusion totals)."""
        tab = self._scalar.get(key)
        if tab is None:
            tab = self._scalar[key] = {}
        return tab

    def scalar_vec(self, key: tuple, fn, uniq: np.ndarray) -> np.ndarray:
        """Vector of ``fn(b)`` over the distinct batch sizes ``uniq``,
        memoized under ``key`` (shared by the accel fast path and the
        cluster runtime's per-slot service model)."""
        tab = self.scalar(key)
        return np.array([
            tab.get(b) if b in tab else tab.setdefault(b, fn(b))
            for b in uniq.tolist()
        ])


class SimCache:
    """Common-random-number probe cache for one (query-size distribution,
    seed): the unit-rate Poisson gap stream, the probe-capped query-size
    resample, and the :class:`_SizeTables` over it.  Sharing one instance
    across every bisection probe and every scheduling configuration of a
    search removes all redundant splitting, duration-table construction and
    random-number generation while reproducing the per-probe streams
    bitwise (``exponential(1/r, n) == unit_gaps[:n] * (1/r)`` and
    ``integers(0, L, n)`` is prefix-stable for NumPy Generators)."""

    def __init__(self, query_sizes: np.ndarray, seed: int = 0):
        self.base_sizes = np.asarray(query_sizes)
        self.seed = int(seed)
        self.unit_gaps = np.random.default_rng(seed).exponential(1.0, _PROBE_CAP)
        r = np.random.default_rng(seed + 17)
        self.sized = self.base_sizes[r.integers(0, len(self.base_sizes), _PROBE_CAP)]
        self.tables = _SizeTables(self.sized)

    def ensure(self, n: int) -> None:
        """Grow the cached streams to capacity >= ``n`` (power-of-two
        regrowth).  NumPy ``Generator`` draws are sequential, so redrawing
        a longer stream from the same seeds reproduces the existing prefix
        bitwise — every probe that fit the old capacity sees identical
        arrays after a grow.  Full-interval simulation (the runtime's
        ``event_core`` path) calls this once up front with the day's
        largest interval population, then every window is a prefix."""
        cap = len(self.unit_gaps)
        if n <= cap:
            return
        new = 1 << (int(n) - 1).bit_length()
        self.unit_gaps = np.random.default_rng(self.seed).exponential(1.0, new)
        r = np.random.default_rng(self.seed + 17)
        self.sized = self.base_sizes[r.integers(0, len(self.base_sizes), new)]
        self.tables = _SizeTables(self.sized)


# ---------------------------------------------------------------------------
# simulation entry points
# ---------------------------------------------------------------------------


def simulate(
    placement: Placement,
    device: DeviceProfile,
    sched: SchedConfig,
    arrival_qps: float,
    query_sizes: np.ndarray,
    seed: int = 0,
    engine: str = "fast",
) -> SimResult:
    rng = np.random.default_rng(seed)
    n = len(query_sizes)
    gaps = rng.exponential(1.0 / max(arrival_qps, 1e-9), n)
    arrivals = np.cumsum(gaps)
    tables = _SizeTables(query_sizes) if engine != "reference" else None
    finish, busy = _run_plan(placement, device, sched, arrivals, query_sizes,
                             engine, tables, n)
    return _metrics(finish, arrivals, busy, device, n)


def simulate_rates(
    placement: Placement,
    device: DeviceProfile,
    sched: SchedConfig,
    rates,
    sla_ms: float,
    query_sizes: np.ndarray,
    seed: int = 0,
    cache: SimCache | None = None,
    engine: str = "fast",
) -> list[SimResult]:
    """Simulate one configuration at several arrival rates, sharing the
    split sub-query arrays, duration tables and common random numbers
    across all rates (each rate reproduces ``simulate`` at that rate)."""
    cache = _checked_cache(cache, query_sizes, seed)
    return [
        _probe(placement, device, sched, float(r), sla_ms, cache, engine)
        for r in rates
    ]


def _checked_cache(cache, query_sizes, seed) -> SimCache:
    """A supplied cache must have been built from the same streams it is
    asked to reproduce — a mismatch would silently change results."""
    if cache is None:
        return SimCache(query_sizes, seed)
    if cache.seed != int(seed) or not np.array_equal(cache.base_sizes,
                                                     query_sizes):
        raise ValueError(
            "SimCache was built for different (query_sizes, seed) than this "
            "call; build one SimCache per (size sample, seed) pair")
    return cache


def _probe(placement, device, sched, rate, sla_ms, cache, engine) -> SimResult:
    duration = max(0.3, 20.0 * sla_ms * 1e-3)
    n = int(np.clip(rate * duration, _PROBE_FLOOR, _PROBE_CAP))
    arrivals = np.cumsum(cache.unit_gaps[:n] * (1.0 / max(rate, 1e-9)))
    sizes = cache.sized[:n]
    tables = cache.tables if engine != "reference" else None
    finish, busy = _run_plan(placement, device, sched, arrivals, sizes,
                             engine, tables, n)
    return _metrics(finish, arrivals, busy, device, n)


def _metrics(finish, arrivals, busy, device, n) -> SimResult:
    latency_ms = (finish - arrivals) * 1e3
    span = max(finish.max() - arrivals[0], 1e-9)
    utils = {
        "cores": min(busy["cores"] / (span * device.cpu.cores), 1.0),
        "mem": min(busy["mem_bytes"] / (span * device.mem.bw_gbs * 1e9), 1.0),
        "engine": min(busy["engine"] / span, 1.0) if device.accel else 0.0,
        "link": min(busy["link"] / span, 1.0) if device.accel else 0.0,
    }
    power = PowerModel(device).average_power(utils)
    p50, p95, p99 = np.percentile(latency_ms, (50, 95, 99))
    return SimResult(
        qps=n / span,
        p50_ms=float(p50),
        p95_ms=float(p95),
        p99_ms=float(p99),
        avg_power_w=power,
        utils=utils,
        n_queries=n,
    )


def _run_plan(placement, device, sched, arrivals, sizes, engine, tables, n):
    busy = {"cores": 0.0, "mem_bytes": 0.0, "engine": 0.0, "link": 0.0}
    blk = True if engine == "event" else None
    if engine == "reference" or tables is None:
        if placement.plan == "cpu_model":
            finish = _sim_cpu_model(placement, device, sched, arrivals, sizes, busy)
        elif placement.plan == "cpu_sd":
            finish = _sim_cpu_sd(placement, device, sched, arrivals, sizes, busy)
        else:
            finish = _sim_accel(placement, device, sched, arrivals, sizes, busy)
        empty = np.asarray(sizes) <= 0
        if empty.any():  # zero-size queries finish at arrival (no work)
            finish = np.where(empty, arrivals, finish)
    elif placement.plan == "cpu_model":
        finish = _fast_cpu_model(placement, device, sched, arrivals, busy,
                                 tables, n, blocked=blk)
    elif placement.plan == "cpu_sd":
        finish = _fast_cpu_sd(placement, device, sched, arrivals, busy,
                              tables, n, blocked=blk)
    else:
        finish = _fast_accel(placement, device, sched, arrivals, busy,
                             tables, n, blocked=blk)
    return finish, busy


def _items_bytes(ops, batch):
    return sum(
        (op.stream_bytes + op.gather_bytes) * batch + op.weight_bytes for op in ops
    )


# ---------------------------------------------------------------------------
# fast path: array sweeps around the k-server FIFO engine
# ---------------------------------------------------------------------------


def _finish_per_query(ends, offsets, n, arrivals):
    """Per-query max over its sub-query ends; empty queries finish at
    arrival.  Sub-queries stay grouped by query in original order."""
    counts = np.diff(offsets[: n + 1])
    finish = np.array(arrivals, dtype=np.float64, copy=True)
    nz = counts > 0
    if nz.any():
        finish[nz] = np.maximum.reduceat(ends, offsets[:n][nz])
    return finish


def _sub_order(sub_a):
    """Processing order of sub-queries (arrival order).  Probe arrivals are
    already sorted (cumsum of non-negative gaps indexed by sorted qid), so
    this is almost always the identity."""
    if len(sub_a) and np.any(np.diff(sub_a) < 0):
        return np.argsort(sub_a, kind="stable")
    return None


def _fast_cpu_model(placement, device, sched, arrivals, busy, tables, n,
                    blocked=None):
    """m threads × o workers; shared sub-query FIFO."""
    d = max(sched.batch, 1)
    sp = tables.split(d)
    ns = int(sp["offsets"][n])
    inv = sp["inv"][:ns]
    sub_a = arrivals[sp["qid"][:ns]]
    dv = tables.cpu_durations(placement.host_ops, sched.o, sched.m, d, device)[inv]
    order = _sub_order(sub_a)
    if order is None:
        ends = fifo_finish(sub_a, dv, sched.m, blocked=blocked)
    else:
        ends = np.empty(ns)
        ends[order] = fifo_finish(sub_a[order], dv[order], sched.m,
                                  blocked=blocked)
    busy["cores"] += float(dv.sum()) * sched.o
    busy["mem_bytes"] += float(tables.op_bytes(placement.host_ops, d)[inv].sum())
    return _finish_per_query(ends, sp["offsets"], n, arrivals)


def _fast_cpu_sd(placement, device, sched, arrivals, busy, tables, n,
                 blocked=None):
    """Sparse pool (sd_sparse × o) -> dense pool (m × 1); dense jobs are
    processed in sub-query arrival order with ready = sparse finish."""
    d = max(sched.batch, 1)
    m_sparse = max(sched.sd_sparse, 1)
    m_dense = max(sched.m, 1)
    sp = tables.split(d)
    ns = int(sp["offsets"][n])
    inv = sp["inv"][:ns]
    sub_a = arrivals[sp["qid"][:ns]]
    ts = tables.cpu_durations(placement.host_sparse, sched.o, m_sparse, d, device)[inv]
    td = tables.cpu_durations(placement.host_dense, 1, m_dense, d, device)[inv]
    order = _sub_order(sub_a)
    if order is None:
        s_end = fifo_finish(sub_a, ts, m_sparse, blocked=blocked)
        ends = fifo_finish(s_end, td, m_dense, blocked=blocked)
    else:
        s_end = fifo_finish(sub_a[order], ts[order], m_sparse,
                            blocked=blocked)
        ends = np.empty(ns)
        ends[order] = fifo_finish(s_end, td[order], m_dense,
                                  blocked=blocked)
    busy["cores"] += float(ts.sum()) * sched.o + float(td.sum())
    busy["mem_bytes"] += float(tables.op_bytes(placement.host_ops, d)[inv].sum())
    return _finish_per_query(ends, sp["offsets"], n, arrivals)


def _fusion_groups(sub_a, sub_s, d, fuse):
    """Greedy fusion boundaries (identical to the reference walk): pack
    consecutive arrival-sorted sub-queries while the fused launch stays
    <= d items and the arrival gap from the group head stays <= 2 ms.
    Returns (group start indices, fused item totals)."""
    ns = len(sub_a)
    cs = np.concatenate([[0], np.cumsum(sub_s)])
    if not fuse:
        return np.arange(ns), sub_s.astype(np.int64)
    idx = np.arange(ns)
    max_w = np.searchsorted(sub_a, sub_a + _FUSE_WINDOW_S, side="right") - idx
    max_s = np.searchsorted(cs, cs[:-1] + d, side="right") - 1 - idx
    lim = np.maximum(np.minimum(max_w, max_s), 1).tolist()
    starts: list[int] = []
    append = starts.append
    pos = 0
    while pos < ns:
        append(pos)
        pos += lim[pos]
    starts = np.asarray(starts, np.int64)
    totals = cs[np.append(starts[1:], ns)] - cs[starts]
    return starts, totals


def _accel_pipeline(ready, tl, te, m, colo0=None, link0=0.0, eng0=0.0,
                    return_state=False):
    """Fused launches through admission (earliest of m co-location slots,
    held until engine completion) -> serialized link -> serialized engine.

    ``colo0``/``link0``/``eng0`` seed the resources' initial free times (a
    continuous-time caller's carried backlog; defaults reproduce the idle
    start bit-for-bit).  With ``return_state`` the end state
    ``(colo free times sorted, link_free, eng_free)`` is returned too."""
    colo = [0.0] * max(m, 1) if colo0 is None else \
        np.asarray(colo0, dtype=np.float64).tolist()
    heapq.heapify(colo)
    replace = heapq.heapreplace
    link_free = float(link0)
    eng_free = float(eng0)
    out: list[float] = []
    append = out.append
    for r, l, t in zip(ready.tolist(), tl.tolist(), te.tolist()):
        s = colo[0]
        if r > s:
            s = r
        l_end = (s if s > link_free else link_free) + l
        e_end = (l_end if l_end > eng_free else eng_free) + t
        link_free = l_end
        eng_free = e_end
        replace(colo, e_end)
        append(e_end)
    if return_state:
        return np.asarray(out), (np.sort(colo), link_free, eng_free)
    return np.asarray(out)


def _fast_accel(placement, device, sched, arrivals, busy, tables, n,
                blocked=None):
    """Host stage pool -> link -> engine, with m-way co-location and query
    fusion; all duration/byte lookups are table sweeps over fused totals.
    The admission/link/engine pipeline itself stays scalar — it is three
    coupled resources, not a k-server pool (see docs/cluster_serving.md)."""
    host_ops = placement.host_ops
    o = max(sched.o, 1)
    host_threads = max(device.cpu.cores // o, 1)
    d = max(sched.batch, 1)
    sp = tables.split(d)
    ns = int(sp["offsets"][n])
    sub_a = arrivals[sp["qid"][:ns]]
    sub_s = sp["sub_s"][:ns]
    order = _sub_order(sub_a)
    if order is not None:
        sub_a, sub_s = sub_a[order], sub_s[order]
    starts, totals = _fusion_groups(sub_a, sub_s, d, sched.fuse)
    bounds = np.append(starts, ns)
    ready = sub_a[bounds[1:] - 1]  # group ready = last (max) member arrival
    uniq_t, inv_t = np.unique(totals, return_inverse=True)

    def table(key, fn):
        return tables.scalar_vec(key, fn, uniq_t)

    if host_ops:
        th_u = table(("cpu_stage", host_ops, o, host_threads, device.name),
                     lambda b: cpu_stage_time(host_ops, b, o, device, host_threads))
        th = th_u[inv_t]
        ready = fifo_finish(ready, th, host_threads, blocked=blocked)
        busy["cores"] += float(th.sum()) * o
        by_u = table(("items_bytes", host_ops), lambda b: _items_bytes(host_ops, b))
        busy["mem_bytes"] += float(by_u[inv_t].sum())
    te = table(("accel_engine", placement.accel_ops, device.name),
               lambda b: accel_engine_time(placement.accel_ops, b, device))[inv_t]
    tl = table(("accel_link", placement.link_bytes_per_item, device.name),
               lambda b: accel_link_time(placement.link_bytes_per_item, b, device))[inv_t]
    e_end = _accel_pipeline(ready, tl, te, sched.m)
    busy["link"] += float(tl.sum())
    busy["engine"] += float(te.sum())
    ends = np.repeat(e_end, np.diff(bounds))
    if order is not None:
        unsorted = np.empty(ns)
        unsorted[order] = ends
        ends = unsorted
    return _finish_per_query(ends, sp["offsets"], n, arrivals)


# ---------------------------------------------------------------------------
# reference path: the original per-sub-query heapq loops (slow ground truth)
# ---------------------------------------------------------------------------


def _duration_table(ops, workers, device, active, sub_s):
    """Memoized service times for the distinct sub-batch sizes."""
    return {
        int(b): cpu_stage_time(ops, int(b), workers, device, active)
        for b in np.unique(sub_s)
    }


def _sim_cpu_model(placement, device, sched, arrivals, sizes, busy):
    """m threads × o workers; shared sub-query FIFO (heap of free times)."""
    ops = placement.host_ops
    sub_a, sub_s, qid = _split_queries(sizes, arrivals, sched.batch)
    durs = _duration_table(ops, sched.o, device, sched.m, sub_s)
    bts = {b: _items_bytes(ops, b) for b in durs}
    free = [0.0] * max(sched.m, 1)
    heapq.heapify(free)
    finish = np.zeros(len(sizes))
    order = np.argsort(sub_a, kind="stable")
    for j in order:
        b = int(sub_s[j])
        t = durs[b]
        start = max(sub_a[j], heapq.heappop(free))
        end = start + t
        heapq.heappush(free, end)
        if end > finish[qid[j]]:
            finish[qid[j]] = end
        busy["cores"] += t * sched.o
        busy["mem_bytes"] += bts[b]
    return finish


def _sim_cpu_sd(placement, device, sched, arrivals, sizes, busy):
    """Sparse pool (sd_sparse threads × o workers) -> dense pool (m × 1).

    Bandwidth/LLC contention is per-pool: the dedicated sparse pool contends
    only with itself — the S-D partition's core advantage."""
    m_sparse = max(sched.sd_sparse, 1)
    m_dense = max(sched.m, 1)
    sub_a, sub_s, qid = _split_queries(sizes, arrivals, sched.batch)
    durs_s = _duration_table(placement.host_sparse, sched.o, device, m_sparse, sub_s)
    durs_d = _duration_table(placement.host_dense, 1, device, m_dense, sub_s)
    bts = {b: _items_bytes(placement.host_ops, b) for b in durs_s}
    free_s = [0.0] * m_sparse
    free_d = [0.0] * m_dense
    heapq.heapify(free_s)
    heapq.heapify(free_d)
    finish = np.zeros(len(sizes))
    order = np.argsort(sub_a, kind="stable")
    for j in order:
        b = int(sub_s[j])
        ts, td = durs_s[b], durs_d[b]
        s_start = max(sub_a[j], heapq.heappop(free_s))
        s_end = s_start + ts
        heapq.heappush(free_s, s_end)
        d_start = max(s_end, heapq.heappop(free_d))
        d_end = d_start + td
        heapq.heappush(free_d, d_end)
        if d_end > finish[qid[j]]:
            finish[qid[j]] = d_end
        busy["cores"] += ts * sched.o + td
        busy["mem_bytes"] += bts[b]
    return finish


def _sim_accel(placement, device, sched, arrivals, sizes, busy):
    """Host stage pool -> link -> engine, with m-way co-location and
    query fusion up to d items per launch."""
    cores = device.cpu.cores
    host_ops = placement.host_ops
    # host pool: remaining cores as sparse threads with o workers each
    host_threads = max(cores // max(sched.o, 1), 1)
    host_pool = _Pool(host_threads)
    link = _Pool(1)
    engine = _Pool(1)
    colocate = _Pool(max(sched.m, 1))  # admission: <= m fused launches in flight

    d = max(sched.batch, 1)
    sub_a, sub_s, qid = _split_queries(sizes, arrivals, d)
    order = np.argsort(sub_a, kind="stable")
    finish = np.zeros(len(sizes))

    # Greedy fusion: walk sub-queries in arrival order, fuse consecutive
    # sub-queries into one launch while total items <= d.
    host_durs: dict[int, float] = {}
    eng_durs: dict[int, float] = {}
    link_durs: dict[int, float] = {}

    def _host_t(b):
        if b not in host_durs:
            host_durs[b] = cpu_stage_time(host_ops, b, sched.o, device, host_threads)
        return host_durs[b]

    def _eng_t(b):
        if b not in eng_durs:
            eng_durs[b] = accel_engine_time(placement.accel_ops, b, device)
        return eng_durs[b]

    def _link_t(b):
        if b not in link_durs:
            link_durs[b] = accel_link_time(placement.link_bytes_per_item, b, device)
        return link_durs[b]

    i = 0
    idx = order.tolist()
    while i < len(idx):
        batch_ids = [idx[i]]
        total = int(sub_s[idx[i]])
        i += 1
        while sched.fuse and i < len(idx) and total + int(sub_s[idx[i]]) <= d:
            # fuse only queries that have already arrived by the time the
            # first arrived (no artificial waiting -> no added queuing delay)
            if sub_a[idx[i]] - sub_a[batch_ids[0]] > _FUSE_WINDOW_S:
                break
            batch_ids.append(idx[i])
            total += int(sub_s[idx[i]])
            i += 1
        ready = max(sub_a[j] for j in batch_ids)
        if host_ops:
            th = _host_t(total)
            _, ready = host_pool.schedule(ready, th)
            busy["cores"] += th * sched.o
            busy["mem_bytes"] += _items_bytes(host_ops, total)
        # admission slot (co-location degree): holds until engine completes
        slot_start, _, slot = colocate.schedule_idx(ready, 0.0)
        tl = _link_t(total)
        _, l_end = link.schedule(slot_start, tl)
        te = _eng_t(total)
        _, e_end = engine.schedule(l_end, te)
        busy["link"] += tl
        busy["engine"] += te
        colocate.free_at[slot] = e_end
        for j in batch_ids:
            finish[qid[j]] = max(finish[qid[j]], e_end)
    return finish


# ---------------------------------------------------------------------------
# latency-bounded throughput
# ---------------------------------------------------------------------------


def capacity_bound_qps(
    placement: Placement,
    device: DeviceProfile,
    sched: SchedConfig,
    mean_query_size: float,
) -> float:
    """Analytic steady-state throughput ceiling (items/s across the binding
    resource, converted to queries/s). Brackets the bisection so the sim is
    never asked to 'sustain' a rate it only drains as a burst."""
    d = max(sched.batch, 1)
    caps = []
    if placement.plan in ("cpu_model", "cpu_sd"):
        if placement.plan == "cpu_model":
            t = cpu_stage_time(placement.host_ops, d, sched.o, device, sched.m)
            caps.append(sched.m * d / max(t, 1e-12))
        else:
            m_s, m_d = max(sched.sd_sparse, 1), max(sched.m, 1)
            ts = cpu_stage_time(placement.host_sparse, d, sched.o, device, m_s)
            td = cpu_stage_time(placement.host_dense, d, 1, device, m_d)
            caps.append(m_s * d / max(ts, 1e-12))
            caps.append(m_d * d / max(td, 1e-12))
    else:
        if placement.host_ops:
            ht = max(device.cpu.cores // max(sched.o, 1), 1)
            th = cpu_stage_time(placement.host_ops, d, sched.o, device, ht)
            caps.append(ht * d / max(th, 1e-12))
        tl = accel_link_time(placement.link_bytes_per_item, d, device)
        te = accel_engine_time(placement.accel_ops, d, device)
        caps.append(d / max(tl, 1e-12))
        caps.append(d / max(te, 1e-12))
    return min(caps) / max(mean_query_size, 1.0)


def _sized_queries(base_sizes: np.ndarray, rate: float, sla_ms: float, seed: int):
    """Resample query sizes so the sim spans >= ~20 SLA windows (steady
    state), capped for runtime. Above the cap the run is burst-shaped; the
    analytic capacity bound caps the reported throughput instead.

    Kept for compatibility: probes now slice the equivalent prefix out of
    :class:`SimCache` instead of re-drawing per rate."""
    duration = max(0.3, 20.0 * sla_ms * 1e-3)
    n = int(np.clip(rate * duration, _PROBE_FLOOR, _PROBE_CAP))
    rng = np.random.default_rng(seed + 17)
    return base_sizes[rng.integers(0, len(base_sizes), n)]


def max_sustainable_qps(
    placement: Placement,
    device: DeviceProfile,
    sched: SchedConfig,
    sla_ms: float,
    query_sizes: np.ndarray,
    power_budget_w: float | None = None,
    seed: int = 0,
    n_bisect: int = 7,
    cache: SimCache | None = None,
    engine: str = "fast",
    qps_tol: float = 0.0,
) -> tuple[float, SimResult | None]:
    """Latency-bounded throughput: max Poisson rate with p95 <= SLA.

    All probes share ``cache`` (CRN), so the p95-vs-rate curve is sampled
    on one noise realization and the bisection bracket is monotone in
    practice; ``qps_tol > 0`` stops early once the bracket is within that
    relative tolerance of the answer (fewer probes at bounded error).
    """
    mean_size = float(np.mean(query_sizes))
    bound = capacity_bound_qps(placement, device, sched, mean_size)
    if bound <= 0:
        return 0.0, None
    cache = _checked_cache(cache, query_sizes, seed)
    lo, hi = 0.0, bound * 1.25
    best: SimResult | None = None
    r = _probe(placement, device, sched, hi, sla_ms, cache, engine)
    if r.meets(sla_ms, power_budget_w):
        # capacity-bound regime: report the analytic ceiling, never more
        return bound, r
    for _ in range(n_bisect):
        if qps_tol > 0.0 and (hi - lo) <= qps_tol * hi:
            break
        mid = 0.5 * (lo + hi)
        r = _probe(placement, device, sched, mid, sla_ms, cache, engine)
        if r.meets(sla_ms, power_budget_w):
            lo, best = mid, r
        else:
            hi = mid
    return min(lo, bound), best
