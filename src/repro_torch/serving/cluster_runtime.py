"""Fleet-scale, query-granular online serving (closing the paper's loop).

``provision_day`` (stage 2, `repro_torch.core.cluster`) trusts the efficiency
table's QPS column: an interval is "served" if the LP covers the load with
profiled throughput numbers.  This module validates that claim the way
DeepRecSys and Hera do — by actually serving queries: it consumes the
allocations of a :class:`~repro_torch.core.cluster.StatefulProvisioner` and
drives Poisson query streams through one
:class:`~repro_torch.serving.router.QueryRouter` per workload, with per-server
behaviour reproduced from the vectorized engine:

- each allocated server instance is a router slot backed by a
  :class:`PairService` — the (workload, server-type) pair's profiled
  optimal placement + scheduling config, whose sub-query splits and
  duration tables come from the shared :class:`~repro_torch.serving.simulator.
  SimCache` (common random numbers across intervals, slots and policies);
- routing is the router's deterministic low-discrepancy weighted
  assignment; newly provisioned servers join the pool only after their
  model load completes, drained servers stop taking queries but finish
  in-flight work (make-before-break when ``drain_s >= model_load_s``);
- mid-day failures land *inside* the measured window: the victim's
  unfinished queries re-dispatch to healthy slots at the detection time,
  and the provisioner re-solves on the shrunken pool at the next interval;
- stragglers hedge once the router's p99-based threshold trips: the
  duplicate is admitted into the alternate slot's **live** queue at
  ``arrival + threshold`` and contends with that slot's in-flight work.

The simulation is **continuous-time across intervals**: each slot's pool
state (the per-server free times — its backlog of unfinished work) is
carried from one measured window into the next, through hysteresis holds,
make-before-break transitions, slot retirement and mid-window failures.
Measured windows therefore abut in queue time; a slot pushed past its
sustainable rate accumulates backlog day-long instead of being quietly
reset to an idle pool at every interval boundary — which is exactly the
regime (utilization → 1) where the paper's feasibility-frontier claims
are decided.  Per-interval latency/SLA series are exposed alongside the
day-level aggregate, and the achieved tail feeds back into the
provisioner's hysteresis decision (``StatefulProvisioner.step(load,
tail_ok=...)``).  See ``docs/cluster_serving.md``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.common.types import resolve_device
from repro_torch.core.cluster import (
    EfficiencyTable,
    StatefulProvisioner,
    TransitionConfig,
)
from repro_torch.core.devices import SERVER_TYPES, DeviceProfile
from repro_torch.core.partition import enumerate_placements
from repro_torch.core.perfmodel import (
    accel_engine_time,
    accel_link_time,
    cpu_stage_time,
)
from repro_torch.core.workload import ModelProfile
from repro_torch.serving.engine import fifo_finish, fifo_finish_state
from repro_torch.serving.event_core import merge_event_streams
from repro_torch.serving.router import QueryRouter, ServerSlot
from repro_torch.serving.simulator import (
    _PROBE_CAP,
    SchedConfig,
    SimCache,
    _accel_pipeline,
    _fusion_groups,
)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the query-granular day simulation."""

    queries_per_interval: int = 1500  # window cap per workload (CRN prefix)
    hedge_quantile: float = 0.99
    hedge_factor: float = 2.0
    sla_quantile: float = 0.95        # "meets SLA" = this quantile <= sla_ms
    carry_backlog: bool = True        # continuous-time: carry pool state
    hedge_live_queue: bool = True     # hedges join the alternate's live queue
    tail_feedback: bool = True        # feed achieved tail into hysteresis
    # --- event core (exact full-interval mode, see event_core.py) ---------
    # event_core=True simulates every arrival of the interval (cap below,
    # not _PROBE_CAP), extends each measured window to the interval end so
    # nothing is bridged by stationarity, batches the per-slot k-server
    # pools through event_core.fleet_fifo_finish, and re-serves a hedge
    # target's own primaries event-ordered (their latencies reflect the
    # duplicate's admission instead of keeping first-pass values)
    event_core: bool = False
    event_core_queries: int = 200_000  # full-interval cap per (workload, t)
    # keep the raw per-(workload, interval) latency arrays on the result
    # (``DayResult.latencies``) — used by the geo layer to attribute spilled
    # queries to their origin region; off by default (event-core days can
    # measure 10^7+ queries)
    collect_latencies: bool = False


@dataclasses.dataclass(frozen=True)
class DayInputs:
    """Everything :func:`simulate_cluster_day` needs about *one* day.

    ``compile_scenario`` produces one of these (``CompiledScenario.inputs``);
    hand-rolled days construct it directly.  The bundle is the day's data —
    which policy serves it and with which runtime knobs stay call-site
    arguments (``simulate_cluster_day(inputs, policy=..., config=...)``), so
    the same inputs can be served under every policy for a CRN comparison.
    """

    table: EfficiencyTable
    records: dict[str, dict]
    profiles: dict[str, ModelProfile]
    traces: np.ndarray                  # [M, T] per-workload diurnal loads
    servers: dict[str, DeviceProfile] | None = None
    overprovision: float = 0.05
    transitions: TransitionConfig | None = None
    failures: list[tuple[int, int, float]] | None = None
    query_sizes: np.ndarray | None = None
    seed: int = 0
    # optional repro_torch.core.colocation.ColocationTable: when set, the
    # provisioner may pack complementary tenants onto shared machines and
    # the runtime serves their per-tenant streams on one machine identity
    # with interference-dilated duration tables.  None (the default) keeps
    # the single-tenant day bitwise unchanged.
    colocation: object | None = None


@dataclasses.dataclass
class DayResult:
    """Typed result of :func:`simulate_cluster_day`.

    ``to_dict()`` reproduces the historical raw-dict shape bit-for-bit
    (``power`` -> ``"power_w"``, ``per_workload`` -> ``"workloads"``), so
    JSON baselines pinned against the old return value stay valid.
    """

    policy: str
    power: np.ndarray                   # [T] provisioned W incl. drain
    capacity: np.ndarray                # [T] machines allocated
    churn: np.ndarray                   # [T] machines added + removed
    feasible: bool
    peak_power_w: float
    avg_power_w: float
    peak_capacity: int
    avg_capacity: float
    resolves: int
    holds: int
    tail_resolves: int
    total_churn: int
    per_workload: dict[str, dict]       # day-level aggregates per workload
    series: dict                        # {"interval_s", "per_workload"}
    all_meet_sla: bool
    events: list[str]
    # raw per-(workload, interval) latency seconds; populated only under
    # RuntimeConfig(collect_latencies=True) and excluded from to_dict()
    latencies: list[list[np.ndarray | None]] | None = None
    # [T] shared (co-located) machines per interval; populated only when
    # the day ran with a colocation table and excluded from to_dict() so
    # pinned single-tenant baselines keep their exact key set
    co_capacity: np.ndarray | None = None

    def to_dict(self) -> dict:
        return {
            "policy": self.policy,
            "power_w": self.power,
            "capacity": self.capacity,
            "churn": self.churn,
            "feasible": self.feasible,
            "peak_power_w": self.peak_power_w,
            "avg_power_w": self.avg_power_w,
            "peak_capacity": self.peak_capacity,
            "avg_capacity": self.avg_capacity,
            "resolves": self.resolves,
            "holds": self.holds,
            "tail_resolves": self.tail_resolves,
            "total_churn": self.total_churn,
            "workloads": self.per_workload,
            "series": self.series,
            "all_meet_sla": self.all_meet_sla,
            "events": self.events,
        }


# ---------------------------------------------------------------------------
# per-slot pool state (the carried backlog)
# ---------------------------------------------------------------------------
#
# A slot's state is a dict of float arrays — one per internal pool resource
# (CPU thread pool, sparse/dense pools, accel host pool / co-location slots
# / link / engine), each entry a server's free time.  Between windows the
# state is stored *relative* to the window end (residual seconds of
# unfinished work); at the next window it is re-anchored at the interval
# start, so a drained slot re-enters idle and an overloaded one re-enters
# exactly as deep in backlog as it left.


def _state_abs(residual: dict[str, np.ndarray], t0: float) -> dict:
    """Anchor a residual (relative-seconds) state at absolute time ``t0``."""
    return {k: t0 + v for k, v in residual.items()}


def _state_residual(state: dict[str, np.ndarray], w_end: float) -> dict:
    """Convert an absolute end-of-window state to residual seconds."""
    return {k: np.maximum(v - w_end, 0.0) for k, v in state.items()}


def _drain_horizon(state: dict[str, np.ndarray], w_end: float) -> float:
    """Seconds past ``w_end`` until the slot is fully drained (0 = idle)."""
    if not state:
        return 0.0
    return max(max(float(v.max()) - w_end, 0.0) for v in state.values())


def _state_copy(state: dict[str, np.ndarray]) -> dict:
    return {k: v.copy() for k, v in state.items()}


# ---------------------------------------------------------------------------
# per-(workload, server-type) service model
# ---------------------------------------------------------------------------


class PairService:
    """Query-granular service model of one (workload, server-type) pair.

    Reproduces the single-server simulator's fast path on an arbitrary
    subset of the CRN query stream: the profiled optimal placement and
    scheduling config define the pool structure, the shared
    :class:`SimCache` supplies sub-query splits and duration tables, and
    the k-server FIFO recurrence / accel admission-link-engine pipeline
    come from :mod:`repro_torch.serving.engine` and the simulator.  ``finish``
    on the full stream prefix is bit-identical to the engine's fast path
    (pinned by ``tests/test_cluster_runtime.py``); with a ``state`` it
    additionally starts from / hands back carried pool backlog.
    """

    def __init__(self, profile: ModelProfile, device: DeviceProfile,
                 record: dict, cache: SimCache, dilation: float = 1.0):
        self.profile = profile
        self.device = device
        self.cache = cache
        # interference dilation of a co-located tenant (>= 1): every pool
        # duration multiplies by it and the sustainable rate divides by it.
        # At exactly 1.0 no multiply runs, keeping the solo path bitwise.
        self.dilation = float(dilation)
        self.qps = float(record["qps"])
        if self.dilation != 1.0:
            self.qps = self.qps / self.dilation
        self.sched = SchedConfig(
            batch=int(record["d"]), m=int(record["m"]), o=int(record["o"]),
            sd_sparse=int(record["sd_sparse"]),
        )
        self.plan = record["plan"]
        placements = enumerate_placements(profile, device)
        by_plan = [p for p in placements if p.plan == self.plan]
        self.placement = by_plan[0] if by_plan else placements[0]
        d = max(self.sched.batch, 1)
        self.d = d
        sp = cache.tables.split(d)
        self.offsets = sp["offsets"]
        self.inv = sp["inv"]
        self.sub_s = sp["sub_s"]
        t, pl, s = cache.tables, self.placement, self.sched
        self.k = max(s.m, 1)
        if self.plan == "cpu_model":
            self.dur = t.cpu_durations(pl.host_ops, s.o, s.m, d, device)
            if self.dilation != 1.0:
                self.dur = self.dur * self.dilation
        elif self.plan == "cpu_sd":
            self.k_sparse = max(s.sd_sparse, 1)
            self.dur_sparse = t.cpu_durations(
                pl.host_sparse, s.o, self.k_sparse, d, device)
            self.dur_dense = t.cpu_durations(pl.host_dense, 1, s.m, d, device)
            if self.dilation != 1.0:
                self.dur_sparse = self.dur_sparse * self.dilation
                self.dur_dense = self.dur_dense * self.dilation
        else:
            self.host_threads = max(device.cpu.cores // max(s.o, 1), 1)

    # -- internals -----------------------------------------------------------

    def _sub_index(self, qidx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Sub-query indices (into the full CRN split) for queries ``qidx``."""
        starts = self.offsets[qidx]
        counts = (self.offsets[qidx + 1] - starts).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64), counts
        cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
        sub = np.repeat(starts - cum0, counts) + np.arange(total)
        return sub, counts

    def _scalar_table(self, key: tuple, fn, uniq: np.ndarray) -> np.ndarray:
        return self.cache.tables.scalar_vec(key, fn, uniq)

    def _accel(self, sub_ready: np.ndarray, sub_s: np.ndarray,
               state: dict | None = None) -> np.ndarray:
        """Fused launches through host pool -> admission -> link -> engine,
        identical to the simulator's ``_fast_accel`` structure."""
        pl, s, dev = self.placement, self.sched, self.device
        starts, totals = _fusion_groups(sub_ready, sub_s.astype(np.int64),
                                        self.d, s.fuse)
        bounds = np.append(starts, len(sub_ready))
        ready = sub_ready[bounds[1:] - 1]
        uniq_t, inv_t = np.unique(totals, return_inverse=True)
        o = max(s.o, 1)
        if pl.host_ops:
            th = self._scalar_table(
                ("cpu_stage", pl.host_ops, o, self.host_threads, dev.name),
                lambda b: cpu_stage_time(pl.host_ops, b, o, dev,
                                         self.host_threads), uniq_t)[inv_t]
            if self.dilation != 1.0:
                th = th * self.dilation
            if state is None:
                ready = fifo_finish(ready, th, self.host_threads)
            else:
                ready, state["host"] = fifo_finish_state(
                    ready, th, self.host_threads, state["host"])
        te = self._scalar_table(
            ("accel_engine", pl.accel_ops, dev.name),
            lambda b: accel_engine_time(pl.accel_ops, b, dev), uniq_t)[inv_t]
        tl = self._scalar_table(
            ("accel_link", pl.link_bytes_per_item, dev.name),
            lambda b: accel_link_time(pl.link_bytes_per_item, b, dev),
            uniq_t)[inv_t]
        if self.dilation != 1.0:
            te = te * self.dilation
            tl = tl * self.dilation
        if state is None:
            e_end = _accel_pipeline(ready, tl, te, s.m)
        else:
            e_end, (colo, link, eng) = _accel_pipeline(
                ready, tl, te, s.m, colo0=state["colo"],
                link0=float(state["link"][0]), eng0=float(state["eng"][0]),
                return_state=True)
            state["colo"] = colo
            state["link"] = np.array([link])
            state["eng"] = np.array([eng])
        return np.repeat(e_end, np.diff(bounds))

    # -- public --------------------------------------------------------------

    def fresh_state(self) -> dict[str, np.ndarray]:
        """Idle pool state (residual form: all zeros), shaped per plan."""
        if self.plan == "cpu_model":
            return {"pool": np.zeros(self.k)}
        if self.plan == "cpu_sd":
            return {"sparse": np.zeros(self.k_sparse),
                    "dense": np.zeros(self.k)}
        st = {"colo": np.zeros(self.k), "link": np.zeros(1),
              "eng": np.zeros(1)}
        if self.placement.host_ops:
            st["host"] = np.zeros(self.host_threads)
        return st

    def finish(self, qidx: np.ndarray, ready: np.ndarray,
               state: dict | None = None) -> np.ndarray:
        """Per-query finish times for CRN-stream queries ``qidx`` entering
        this server's pools at ``ready`` (sorted).  Without ``state`` the
        pools start idle (the historical, bit-pinned path); with a
        ``state`` dict (absolute free times, see :func:`_state_abs`) the
        pools start from the carried backlog and ``state`` is updated in
        place to the end-of-stream pool state."""
        qidx = np.asarray(qidx, np.int64)
        out = np.array(ready, dtype=np.float64, copy=True)
        if len(qidx) == 0:
            return out
        sub, counts = self._sub_index(qidx)
        nz = counts > 0
        if not nz.any():
            return out
        sub_ready = np.repeat(out, counts)
        inv = self.inv[sub]
        if self.plan == "cpu_model":
            if state is None:
                ends = fifo_finish(sub_ready, self.dur[inv], self.k)
            else:
                ends, state["pool"] = fifo_finish_state(
                    sub_ready, self.dur[inv], self.k, state["pool"])
        elif self.plan == "cpu_sd":
            if state is None:
                s_end = fifo_finish(sub_ready, self.dur_sparse[inv],
                                    self.k_sparse)
                ends = fifo_finish(s_end, self.dur_dense[inv], self.k)
            else:
                s_end, state["sparse"] = fifo_finish_state(
                    sub_ready, self.dur_sparse[inv], self.k_sparse,
                    state["sparse"])
                ends, state["dense"] = fifo_finish_state(
                    s_end, self.dur_dense[inv], self.k, state["dense"])
        else:
            ends = self._accel(sub_ready, self.sub_s[sub], state)
        cum0 = np.concatenate([[0], np.cumsum(counts)])
        out[nz] = np.maximum.reduceat(ends, cum0[:-1][nz])
        return out

    def solo_time(self, qidx: np.ndarray) -> np.ndarray:
        """Unloaded per-query service time (lower bound on any completion):
        list-scheduling wave bound ``max(longest sub-query, work / k)`` per
        pool stage; serialized link+engine on accelerators."""
        qidx = np.asarray(qidx, np.int64)
        sub, counts = self._sub_index(qidx)
        out = np.zeros(len(qidx))
        nz = counts > 0
        if not nz.any():
            return out
        cuts = np.concatenate([[0], np.cumsum(counts)])[:-1][nz]

        def wave(dur: np.ndarray, k: int) -> np.ndarray:
            longest = np.maximum.reduceat(dur, cuts)
            work = np.add.reduceat(dur, cuts)
            return np.maximum(longest, work / max(k, 1))

        inv = self.inv[sub]
        if self.plan == "cpu_model":
            out[nz] = wave(self.dur[inv], self.k)
        elif self.plan == "cpu_sd":
            out[nz] = wave(self.dur_sparse[inv], self.k_sparse) + \
                wave(self.dur_dense[inv], self.k)
        else:
            pl, dev = self.placement, self.device
            uniq, inv_s = np.unique(self.sub_s[sub], return_inverse=True)
            te = self._scalar_table(
                ("accel_engine", pl.accel_ops, dev.name),
                lambda b: accel_engine_time(pl.accel_ops, b, dev), uniq)
            tl = self._scalar_table(
                ("accel_link", pl.link_bytes_per_item, dev.name),
                lambda b: accel_link_time(pl.link_bytes_per_item, b, dev),
                uniq)
            if self.dilation != 1.0:
                te = te * self.dilation
                tl = tl * self.dilation
            per_sub = (te + tl)[inv_s]
            out[nz] = np.add.reduceat(per_sub, cuts)
            if pl.host_ops:
                th = self._scalar_table(
                    ("cpu_stage", pl.host_ops, max(self.sched.o, 1),
                     self.host_threads, dev.name),
                    lambda b: cpu_stage_time(pl.host_ops, b,
                                             max(self.sched.o, 1), dev,
                                             self.host_threads), uniq)[inv_s]
                if self.dilation != 1.0:
                    th = th * self.dilation
                out[nz] += wave(th, self.host_threads)
        return out


# ---------------------------------------------------------------------------
# batched slot solving (event-core fleet path)
# ---------------------------------------------------------------------------


def _reduce_queries(out, ends, counts, nz):
    """Per-query max over sub-query ends (PairService.finish epilogue)."""
    cum0 = np.concatenate([[0], np.cumsum(counts)])
    out[nz] = np.maximum.reduceat(ends, cum0[:-1][nz])


def _finish_many(jobs, fleet: bool = False,
                 device="cuda") -> list[np.ndarray]:
    """Finish a batch of per-slot query streams.

    ``jobs`` is a list of ``(svc, qidx, ready, state)`` — one entry per
    slot; states are updated in place.  With ``fleet=False`` this is the
    historical sequential pass (one ``svc.finish`` per slot).  With
    ``fleet=True`` all k > 1 front pools (cpu_model thread pools, cpu_sd
    sparse pools) solve in one :func:`event_core.fleet_fifo_finish` call,
    then all dependent cpu_sd dense pools in a second — amortizing the
    per-step cost across slots (the recurrence is sequential per stream
    but embarrassingly parallel across slots).  ``k == 1`` pools keep the
    engine's Lindley dispatch and the accel admission/link/engine pipeline
    stays scalar (three coupled serialized resources, not a k-server
    pool), so every stream is bitwise-identical to its sequential
    ``svc.finish`` result.  ``device`` is where the fleet's wide groups
    run (the fleet FIFO kernel on ``"cuda"``, its plain version on
    ``"cpu"``)."""
    if not fleet:
        return [svc.finish(qidx, ready, state=state)
                for (svc, qidx, ready, state) in jobs]
    from repro_torch.serving import event_core

    outs: list[np.ndarray] = []
    pre: list[tuple | None] = []
    for (svc, qidx, ready, state) in jobs:
        qidx = np.asarray(qidx, np.int64)
        out = np.array(ready, dtype=np.float64, copy=True)
        outs.append(out)
        if len(qidx) == 0:
            pre.append(None)
            continue
        sub, counts = svc._sub_index(qidx)
        nz = counts > 0
        if not nz.any():
            pre.append(None)
            continue
        sub_ready = np.repeat(out, counts)
        pre.append((svc, sub, counts, nz, sub_ready, svc.inv[sub], state))

    stage1: list[tuple[int, tuple]] = []   # k>1 front pools
    for j, p in enumerate(pre):
        if p is None:
            continue
        svc, sub, counts, nz, sub_ready, inv, state = p
        if svc.plan == "cpu_model" and svc.k > 1:
            stage1.append((j, (sub_ready, svc.dur[inv], svc.k,
                               state["pool"])))
        elif svc.plan == "cpu_sd" and svc.k_sparse > 1:
            stage1.append((j, (sub_ready, svc.dur_sparse[inv],
                               svc.k_sparse, state["sparse"])))
    ends1: dict[int, np.ndarray] = {}
    for (j, _), (e, st_out) in zip(
            stage1, event_core.fleet_fifo_finish([s for _, s in stage1],
                                         device=device)):
        svc = pre[j][0]
        ends1[j] = e
        key = "pool" if svc.plan == "cpu_model" else "sparse"
        pre[j][6][key] = st_out

    stage2: list[tuple[int, tuple]] = []   # cpu_sd dense pools (chained)
    for j, p in enumerate(pre):
        if p is None:
            continue
        svc, sub, counts, nz, sub_ready, inv, state = p
        if svc.plan == "cpu_model":
            if svc.k > 1:
                e = ends1[j]
            else:
                e, state["pool"] = fifo_finish_state(
                    sub_ready, svc.dur[inv], svc.k, state["pool"])
            _reduce_queries(outs[j], e, counts, nz)
        elif svc.plan == "cpu_sd":
            if svc.k_sparse > 1:
                s_end = ends1[j]
            else:
                s_end, state["sparse"] = fifo_finish_state(
                    sub_ready, svc.dur_sparse[inv], svc.k_sparse,
                    state["sparse"])
            if svc.k > 1:
                stage2.append((j, (s_end, svc.dur_dense[inv], svc.k,
                                   state["dense"])))
            else:
                e, state["dense"] = fifo_finish_state(
                    s_end, svc.dur_dense[inv], svc.k, state["dense"])
                _reduce_queries(outs[j], e, counts, nz)
        else:
            e = svc._accel(sub_ready, svc.sub_s[sub], state)
            _reduce_queries(outs[j], e, counts, nz)
    for (j, _), (e, st_out) in zip(
            stage2, event_core.fleet_fifo_finish([s for _, s in stage2],
                                         device=device)):
        svc, sub, counts, nz, sub_ready, inv, state = pre[j]
        state["dense"] = st_out
        _reduce_queries(outs[j], e, counts, nz)
    return outs


# ---------------------------------------------------------------------------
# failure schedules
# ---------------------------------------------------------------------------


def failure_schedule(n_steps: int, n_servers: int, fail_prob: float,
                     seed: int = 0) -> list[tuple[int, int, float]]:
    """``(interval, server_type, window_frac)`` events: each server type
    loses one machine with probability ``fail_prob`` per interval, at
    ``window_frac`` of the measured query window (so failover is observed
    at query granularity).  Deterministic in ``seed`` — share one schedule
    across policies for a fair (CRN) comparison."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_steps):
        for h in range(n_servers):
            if rng.random() < fail_prob:
                out.append((t, h, float(rng.uniform(0.2, 0.8))))
    return out


# ---------------------------------------------------------------------------
# the day simulation
# ---------------------------------------------------------------------------


def _percentiles(lat_ms: np.ndarray) -> tuple[float, float, float]:
    p50, p95, p99 = np.percentile(lat_ms, (50, 95, 99))
    return float(p50), float(p95), float(p99)


def simulate_cluster_day(
    inputs: DayInputs | EfficiencyTable,
    records: dict[str, dict] | None = None,
    profiles: dict[str, ModelProfile] | None = None,
    traces: np.ndarray | None = None,   # [M, T] per-workload diurnal loads
    policy: str = "hercules",
    servers: dict[str, DeviceProfile] | None = None,
    overprovision: float = 0.05,
    transitions: TransitionConfig | None = None,
    config: RuntimeConfig | None = None,
    failures: list[tuple[int, int, float]] | None = None,
    query_sizes: np.ndarray | None = None,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
) -> DayResult:
    """Serve a full diurnal day at query granularity, continuous in time.

    ``inputs`` is a :class:`DayInputs` (``table``/``records`` from
    ``efficiency.build_table``, ``profiles`` mapping workload name ->
    :class:`ModelProfile`); ``policy`` and ``config`` select how the day is
    served.  Returns a :class:`DayResult`: the provisioning series (power
    incl. transition drain, capacity, resolves/holds/churn), *achieved*
    per-workload latency percentiles and SLA attainment — the numbers
    ``provision_day`` only asserts via the QPS column — plus a per-interval
    ``series`` block (the Fig. 8b-style SLA-over-the-day record) and the
    carried-backlog trajectory.

    The pre-``DayInputs`` 13-argument call (table/records/profiles/traces
    passed loose) still works but raises a :class:`DeprecationWarning`; it
    wraps the arguments into a ``DayInputs`` and is bit-identical to the
    bundled call (pinned by ``tests/test_geo.py``).

    ``device`` is where an ``event_core`` day's fleet groups run: the
    fleet FIFO kernel on ``"cuda"`` (the default; raises without a card),
    its plain version on ``"cpu"``.  Every other stage is numpy on the
    host, and the result does not depend on the device.
    """
    device = resolve_device(device)
    if not isinstance(inputs, DayInputs):
        warnings.warn(
            "simulate_cluster_day(table, records, profiles, traces, ...) is "
            "deprecated; bundle the day into DayInputs and call "
            "simulate_cluster_day(inputs, policy=..., config=...)",
            DeprecationWarning, stacklevel=2)
        inputs = DayInputs(
            table=inputs, records=records, profiles=profiles, traces=traces,
            servers=servers, overprovision=overprovision,
            transitions=transitions, failures=failures,
            query_sizes=query_sizes, seed=seed)
    table, records, profiles = inputs.table, inputs.records, inputs.profiles
    traces = inputs.traces
    overprovision = inputs.overprovision
    failures = inputs.failures
    seed = inputs.seed
    servers = inputs.servers or SERVER_TYPES
    cfg = config or RuntimeConfig()
    transitions = inputs.transitions or TransitionConfig()
    query_sizes = inputs.query_sizes
    if query_sizes is None:
        from repro_torch.core.efficiency import default_query_sizes
        query_sizes = default_query_sizes()
    M, T = traces.shape
    H = len(table.servers)
    cache = SimCache(query_sizes, seed)
    if cfg.event_core:
        cap_q = int(cfg.event_core_queries)
        # grow the CRN streams once, up front, to the day's largest
        # interval population: every window is then a bitwise prefix of
        # the same streams and no PairService ever binds stale tables
        n_max = int(np.clip(float(traces.max()) * transitions.interval_s,
                            64, cap_q))
        cache.ensure(n_max)
    else:
        cap_q = min(cfg.queries_per_interval, _PROBE_CAP)
    services: dict[tuple[int, int], PairService] = {}

    def service(h: int, m: int) -> PairService:
        key = (h, m)
        if key not in services:
            rec = records[f"{table.workloads[m]}|{table.servers[h]}"]
            services[key] = PairService(
                profiles[table.workloads[m]], servers[table.servers[h]],
                rec, cache)
        return services[key]

    # shared-machine services: the tenant's solo record with its duration
    # tables dilated by the co-resident set's interference factor, keyed
    # separately so solo services stay untouched
    co_services: dict[tuple, PairService] = {}

    def co_service(m: int, c) -> PairService:
        name = table.workloads[m]
        f = c.dilation_of(name)
        key = (c.server, c.tenants, m, f)
        if key not in co_services:
            rec = records[f"{name}|{c.server}"]
            co_services[key] = PairService(
                profiles[name], servers[c.server], rec, cache, dilation=f)
        return co_services[key]

    prov = StatefulProvisioner(table, policy, overprovision, transitions,
                               seed=seed, colocation=inputs.colocation)
    routers = [QueryRouter([], hedge_quantile=cfg.hedge_quantile,
                           hedge_factor=cfg.hedge_factor, seed=seed + m)
               for m in range(M)]
    fail_by_t: dict[int, list[tuple[int, float]]] = {}
    for (ft, fh, frac) in failures or []:
        fail_by_t.setdefault(ft, []).append((fh, frac))

    power = np.zeros(T)
    capacity = np.zeros(T, np.int64)
    churn = np.zeros(T, np.int64)
    co_cap = np.zeros(T, np.int64)
    events: list[str] = []
    feasible = True
    # per-(workload, interval) latency arrays (None = not measured) and the
    # carried-backlog trajectory (seconds of residual work at window end)
    lat_mt: list[list[np.ndarray | None]] = [[None] * T for _ in range(M)]
    backlog_mt = np.zeros((M, T))
    # per-workload residual slot states keyed by (server type, instance)
    slot_states: list[dict[tuple[int, int], dict]] = [{} for _ in range(M)]
    n_hedged = np.zeros(M, np.int64)
    n_retried = np.zeros(M, np.int64)
    bridged_mt: list[list] = [[None] * T for _ in range(M)]
    tail_ok_prev = True

    for t in range(T):
        step = prov.step(traces[:, t], tail_ok=tail_ok_prev)
        power[t] = step.power_w
        capacity[t] = step.capacity
        churn[t] = step.churn
        if not step.feasible:
            feasible = False
            events.append(f"t={t}: {policy} infeasible on surviving pool")
        t0 = t * transitions.interval_s
        co_cap[t] = len(step.coalloc)
        # map this interval's failures onto serving victims: solo (h, m)
        # cells, or a shared CoMachine whose loss hits every tenant
        victims_by_m: dict[int, list[tuple]] = {}
        for (fh, frac) in fail_by_t.get(t, []):
            before = int(prov.avail[fh])
            cells = prov.fail(fh)
            if not cells:
                if int(prov.avail[fh]) < before:
                    events.append(
                        f"t={t}: spare {table.servers[fh]} failed")
                continue
            for v in cells:
                if isinstance(v, tuple):
                    h, m = v
                    victims_by_m.setdefault(m, []).append((h, frac))
                    events.append(
                        f"t={t}: serving {table.servers[h]} failed "
                        f"({table.workloads[m]}) -> re-route + re-provision")
                else:  # shared machine: every tenant pool loses its view
                    g = ("c", v.server, v.tenants)
                    for name in v.tenants:
                        victims_by_m.setdefault(
                            table.workloads.index(name), []).append((g, frac))
                    events.append(
                        f"t={t}: shared {v.server} failed "
                        f"({'+'.join(v.tenants)}) -> re-route + re-provision")

        for m in range(M):
            rate = float(traces[m, t])
            if rate <= 0.0:
                slot_states[m] = {}  # a whole idle interval drains the pool
                continue
            if step.alloc[:, m].sum() == 0 and not any(
                    table.workloads[m] in c.tenants
                    and c.rate_of(table.workloads[m]) > 0.0
                    for c in step.coalloc):
                feasible = False
                slot_states[m] = {}
                events.append(f"t={t}: {table.workloads[m]} unallocated")
                continue
            n = int(np.clip(rate * transitions.interval_s, 64, cap_q))
            arrivals = t0 + np.cumsum(cache.unit_gaps[:n] * (1.0 / rate))
            span = float(arrivals[-1] - arrivals[0])
            w_end = float(arrivals[-1])
            # a window that did not reach the interval end is bridged by
            # stationarity (the historical approximation); the event core
            # instead measures to the interval boundary so carried backlog
            # sees the real inter-window drain
            bridged_mt[m][t] = bool(n == cap_q
                                    and w_end < t0 + transitions.interval_s)
            if cfg.event_core:
                w_end = max(w_end, t0 + transitions.interval_s)

            # build the slot pool; each serving machine keeps a stable
            # (type, instance) identity so its backlog carries across
            # intervals — removed machines become draining slots that
            # inherit (and finish) their backlog, added ones start idle
            prev_states = slot_states[m] if cfg.carry_backlog else {}
            slots: list[ServerSlot] = []
            pair_of: list[PairService] = []
            states: list[dict] = []      # absolute, updated by the passes
            keys: list[tuple[int, int] | None] = []  # None = no carry-out
            for h in range(H):
                cnt = int(step.alloc[h, m])
                add = int(step.added[h, m])
                rem = int(step.removed[h, m])
                if cnt + rem == 0:
                    continue
                svc = service(h, m)
                keep = cnt - add
                for i in range(cnt):
                    ready = t0 + transitions.model_load_s \
                        if i >= keep else t0
                    slots.append(ServerSlot(table.servers[h], svc.qps,
                                            ready_at=ready))
                    pair_of.append(svc)
                    res = prev_states.get((h, i)) if i < keep else None
                    states.append(_state_abs(
                        res if res is not None else svc.fresh_state(), t0))
                    keys.append((h, i))
                for j in range(rem):  # draining: serves until the deadline
                    slots.append(ServerSlot(
                        table.servers[h], svc.qps, ready_at=t0,
                        retire_at=t0 + transitions.drain_s))
                    pair_of.append(svc)
                    res = prev_states.get((h, keep + j))
                    states.append(_state_abs(
                        res if res is not None else svc.fresh_state(), t0))
                    keys.append(None)
            # shared (co-located) machines: one slot per tenant pool per
            # machine, weighted by the tenant's assigned rate and carrying
            # a composite ("c", server, tenants, i) machine identity so a
            # hardware failure correlates across every tenant it serves
            name_m = table.workloads[m]
            co_cur: dict[tuple, list] = {}
            for c in step.coalloc:
                if name_m in c.tenants:
                    co_cur.setdefault(("c", c.server, c.tenants),
                                      []).append(c)
            co_rem: dict[tuple, list] = {}
            for c in step.co_removed:
                if name_m in c.tenants:
                    co_rem.setdefault(("c", c.server, c.tenants),
                                      []).append(c)
            co_add: dict[tuple, list] = {}
            for c in step.co_added:
                if name_m in c.tenants:
                    co_add.setdefault(("c", c.server, c.tenants),
                                      []).append(c)
            for g in sorted(set(co_cur) | set(co_rem)):
                cur = co_cur.get(g, [])
                # kept machines first: they map onto carried (g, i) states,
                # newly added ones load their model before serving
                pend = list(co_add.get(g, []))
                kept_c, fresh_c = [], []
                for c in cur:
                    if c in pend:
                        pend.remove(c)
                        fresh_c.append(c)
                    else:
                        kept_c.append(c)
                cur = kept_c + fresh_c
                keep = len(kept_c)
                for i, c in enumerate(cur):
                    rate_c = c.rate_of(name_m)
                    if rate_c <= 0.0:
                        continue
                    svc = co_service(m, c)
                    ready = t0 + transitions.model_load_s \
                        if i >= keep else t0
                    slots.append(ServerSlot(c.server, rate_c,
                                            ready_at=ready,
                                            machine=g + (i,)))
                    pair_of.append(svc)
                    res = prev_states.get((g, i)) if i < keep else None
                    states.append(_state_abs(
                        res if res is not None else svc.fresh_state(), t0))
                    keys.append((g, i))
                for j, c in enumerate(co_rem.get(g, [])):
                    rate_c = c.rate_of(name_m)
                    if rate_c <= 0.0:
                        continue
                    svc = co_service(m, c)
                    slots.append(ServerSlot(
                        c.server, rate_c, ready_at=t0,
                        retire_at=t0 + transitions.drain_s,
                        machine=g + (len(cur) + j,)))
                    pair_of.append(svc)
                    res = prev_states.get((g, keep + j))
                    states.append(_state_abs(
                        res if res is not None else svc.fresh_state(), t0))
                    keys.append(None)
            router = routers[m]
            router.refresh(slots)
            thr = router.hedge_threshold()
            carry_in = [_state_copy(st) for st in states] \
                if cfg.hedge_live_queue and np.isfinite(thr) else None

            # mid-window failures: victim stops taking queries at t_f.
            # A tuple key is a shared machine's identity — every tenant
            # pool retires the same machine index; an int key is a solo
            # server type (shared slots are excluded from its match)
            fail_times: list[tuple[int, float]] = []
            for (h, frac) in victims_by_m.get(m, []):
                t_f = float(arrivals[0] + frac * span)
                if isinstance(h, tuple):
                    vi = next((i for i, s in enumerate(slots)
                               if s.machine is not None
                               and s.machine[:3] == h
                               and s.accepts(t_f)), None)
                else:
                    vi = next((i for i, s in enumerate(slots)
                               if s.machine is None
                               and s.server_type == table.servers[h]
                               and s.accepts(t_f)), None)
                if vi is None:
                    continue
                slots[vi].retire_at = t_f
                keys[vi] = None          # a dead machine carries nothing
                fail_times.append((vi, t_f))

            try:
                assigned = router.assign_stream(arrivals)
            except RuntimeError:
                feasible = False
                slot_states[m] = {}
                events.append(f"t={t}: {table.workloads[m]} had no ready "
                              "servers in the window")
                continue
            ready = arrivals.copy()
            latency = np.zeros(n)
            done = np.zeros(n, bool)

            # failed slots first: finished-before-failure queries complete,
            # the rest re-dispatch to healthy slots at the detection time
            for (vi, t_f) in fail_times:
                qv = np.flatnonzero(assigned == vi)
                if len(qv) == 0:
                    router.mark_failed(slots[vi])
                    continue
                # an earlier victim's retries may have landed here: FIFO
                # order is by ready time, not stream index
                qv = qv[np.argsort(ready[qv], kind="stable")]
                f = pair_of[vi].finish(qv, ready[qv], state=states[vi])
                ok = f <= t_f
                latency[qv[ok]] = f[ok] - arrivals[qv[ok]]
                done[qv[ok]] = True
                router.mark_failed(slots[vi])
                lost = qv[~ok]
                if len(lost):
                    ready[lost] = t_f
                    try:
                        assigned[lost] = router.assign_stream(ready[lost])
                        n_retried[m] += len(lost)
                    except RuntimeError:
                        feasible = False
                        latency[lost] = np.inf
                        done[lost] = True
                        events.append(
                            f"t={t}: {table.workloads[m]} lost queries — "
                            "no healthy servers left to retry on")

            streams: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            jobs: list[tuple] = []
            job_q: list[np.ndarray] = []
            for si, svc in enumerate(pair_of):
                qs = np.flatnonzero((assigned == si) & ~done)
                if len(qs) == 0:
                    continue
                order = np.argsort(ready[qs], kind="stable")
                qs = qs[order]
                jobs.append((svc, qs, ready[qs], states[si]))
                job_q.append(qs)
                streams[si] = (qs, ready[qs])
            for qs, f in zip(job_q,
                             _finish_many(jobs, fleet=cfg.event_core,
                                          device=device)):
                latency[qs] = f - arrivals[qs]
                done[qs] = True

            # straggler hedging: a duplicate issued at arrival + threshold
            # is admitted into the alternate slot's live queue — it rides
            # the slot's carried backlog plus its in-window stream, so a
            # busy alternate cannot complete the hedge faster than its own
            # queue allows (first completion wins)
            if np.isfinite(thr) and len(slots) > 1:
                straggler, t_issue, alt = router.hedge_events(
                    assigned, arrivals, latency, thr)
                ok = alt >= 0
                if len(straggler) and cfg.event_core \
                        and carry_in is not None:
                    # event-ordered pass: one merged re-simulation per
                    # target slot, duplicates interleaved into the slot's
                    # primary stream at their issue times.  The target's
                    # own primaries are re-served in that order, so their
                    # latencies now REFLECT the duplicate's admission
                    # (the exact coupling the first-pass model bridges);
                    # each straggler keeps first-completion-wins.
                    alts = np.unique(alt[ok])
                    hjobs, hmeta = [], []
                    for a in alts:
                        sel = straggler[ok & (alt == a)]
                        ti = arrivals[sel] + thr
                        prim_q, prim_r = streams.get(
                            a, (np.zeros(0, np.int64), np.zeros(0)))
                        times, order = merge_event_streams(prim_r, ti)
                        mq = np.concatenate([prim_q, sel])[order]
                        st = _state_copy(carry_in[a])
                        hjobs.append((pair_of[a], mq, times, st))
                        hmeta.append((a, sel, prim_q, order, st))
                    fins = _finish_many(hjobs, fleet=True, device=device)
                    # apply all primary re-serves first, then the
                    # duplicate minima, so a straggler that is also a
                    # perturbed primary competes against its updated
                    # first-pass finish
                    dup_lat = []
                    for (a, sel, prim_q, order, st), f_all in zip(hmeta,
                                                                  fins):
                        pos = np.empty(len(order), np.int64)
                        pos[order] = np.arange(len(order))
                        latency[prim_q] = \
                            f_all[pos[:len(prim_q)]] - arrivals[prim_q]
                        dup_lat.append(f_all[pos[len(prim_q):]]
                                       - arrivals[sel])
                        states[a] = st
                    for (a, sel, _, _, _), hedged in zip(hmeta, dup_lat):
                        better = hedged < latency[sel]
                        latency[sel[better]] = hedged[better]
                        n_hedged[m] += int(better.sum())
                elif len(straggler):
                    for a in np.unique(alt[ok]):
                        sel = straggler[ok & (alt == a)]
                        ti = arrivals[sel] + thr
                        if carry_in is not None:
                            prim_q, prim_r = streams.get(
                                a, (np.zeros(0, np.int64), np.zeros(0)))
                            mq = np.concatenate([prim_q, sel])
                            mr = np.concatenate([prim_r, ti])
                            order = np.argsort(mr, kind="stable")
                            st = _state_copy(carry_in[a])
                            f_all = pair_of[a].finish(mq[order], mr[order],
                                                      state=st)
                            pos = np.empty(len(mq), np.int64)
                            pos[order] = np.arange(len(mq))
                            hedged = f_all[pos[len(prim_q):]] - arrivals[sel]
                            # the merged pass re-serves the primaries too;
                            # their first-pass latencies stand (duplicates
                            # are a tail mechanism, not extra accounting),
                            # but the slot's carried state now includes the
                            # hedge work it actually absorbed
                            states[a] = st
                        else:  # legacy optimistic model: unloaded service
                            hedged = (ti - arrivals[sel]) + \
                                pair_of[a].solo_time(sel)
                        better = hedged < latency[sel]
                        latency[sel[better]] = hedged[better]
                        n_hedged[m] += int(better.sum())
            router.observe_many(latency[np.isfinite(latency)])
            lat_mt[m][t] = latency

            # carry-out: serving machines that survived the window keep
            # their residual backlog under a compacted instance index (a
            # failed machine's slot disappears; draining slots retire)
            new_states: dict[tuple[int, int], dict] = {}
            counters: dict[int, int] = {}
            bl = 0.0
            for si, key in enumerate(keys):
                if key is None:
                    continue
                h = key[0]
                idx = counters.get(h, 0)
                counters[h] = idx + 1
                bl += _drain_horizon(states[si], w_end)
                new_states[(h, idx)] = _state_residual(states[si], w_end)
            backlog_mt[m, t] = bl
            slot_states[m] = new_states if cfg.carry_backlog else {}

        # achieved-tail feedback for the next provisioning decision
        if cfg.tail_feedback:
            ok = True
            for m in range(M):
                lat = lat_mt[m][t]
                if lat is None:
                    continue
                if not np.isfinite(lat).all():
                    ok = False
                    break
                sla = profiles[table.workloads[m]].sla_ms
                if float(np.quantile(lat, cfg.sla_quantile)) * 1e3 > sla:
                    ok = False
                    break
            tail_ok_prev = ok

    # day-level aggregates + the per-interval (Fig. 8b-style) series
    workloads = {}
    series: dict[str, dict] = {}
    all_meet = True
    for m, name in enumerate(table.workloads):
        sla = profiles[name].sla_ms
        measured = [lat for lat in lat_mt[m] if lat is not None]
        lat_ms = np.concatenate(measured) * 1e3 if measured else \
            np.array([np.inf])
        p50, p95, p99 = _percentiles(lat_ms)
        q = float(np.quantile(lat_ms, cfg.sla_quantile))
        attainment = float(np.mean(lat_ms <= sla))
        meets = q <= sla
        all_meet &= meets
        s: dict[str, list] = {k: [] for k in (
            "p50_ms", "p95_ms", "p99_ms", "sla_attainment", "meets_sla",
            "n_queries")}
        met_t = 0
        for t in range(T):
            lat = lat_mt[m][t]
            if lat is None:
                for k in s:
                    s[k].append(None)
                continue
            ms = lat * 1e3
            i50, i95, i99 = _percentiles(ms)
            s["p50_ms"].append(i50)
            s["p95_ms"].append(i95)
            s["p99_ms"].append(i99)
            s["sla_attainment"].append(float(np.mean(ms <= sla)))
            im = bool(float(np.quantile(ms, cfg.sla_quantile)) <= sla)
            s["meets_sla"].append(im)
            s["n_queries"].append(int(len(ms)))
            met_t += im
        s["backlog_s"] = [float(b) for b in backlog_mt[m]]
        # True = window hit the query cap before the interval end and the
        # remainder is stationarity-bridged; False = fully simulated
        # (always False under cfg.event_core unless event_core_queries is
        # exceeded); None = interval not measured
        s["bridged"] = bridged_mt[m]
        n_meas = sum(1 for lat in lat_mt[m] if lat is not None)
        series[name] = s
        workloads[name] = {
            "sla_ms": sla, "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "sla_attainment": attainment, "meets_sla": bool(meets),
            "interval_sla_met_frac":
                float(met_t / n_meas) if n_meas else 0.0,
            "n_queries": int(len(lat_ms)), "n_hedged": int(n_hedged[m]),
            "n_retried": int(n_retried[m]),
        }
    return DayResult(
        policy=policy,
        power=power,
        capacity=capacity,
        churn=churn,
        feasible=feasible,
        peak_power_w=float(power.max()),
        avg_power_w=float(power.mean()),
        peak_capacity=int(capacity.max()),
        avg_capacity=float(capacity.mean()),
        resolves=prov.n_resolves,
        holds=prov.n_holds,
        tail_resolves=prov.n_tail_resolves,
        total_churn=int(churn.sum()),
        per_workload=workloads,
        series={
            "interval_s": transitions.interval_s,
            "per_workload": series,
        },
        all_meet_sla=bool(all_meet),
        events=events,
        latencies=lat_mt if cfg.collect_latencies else None,
        co_capacity=co_cap if inputs.colocation is not None else None,
    )
