"""Gradient-based task-scheduling search (paper Algorithm 1, Figs. 11/12).

Explores P(M+D+O) for every feasible partition plan of a (workload, server)
pair. Exploiting the convexity of the P(M+D) throughput surface, the walk
starts at the minimal (m, d) corner and repeatedly evaluates the three-
candidate frontier — grow m, grow d, grow both — moving to the best QPS
improvement that still meets the SLA latency and provisioned-power
constraints; it terminates when all three regress. The outer loop sweeps
op-parallelism o and stops when the per-o peak starts decreasing (paper's
early stop).

Every evaluation is a latency-bounded-throughput measurement from the
discrete-event simulator; evaluations are memoized, and the search reports
how much of the exhaustive space it visited (the paper's search-efficiency
claim).  All evaluations of one search — the frontier candidates of every
step, every o, every plan, and every bisection probe inside them — run
through one shared :class:`~repro_torch.serving.simulator.SimCache`, so arrival
streams (common random numbers), query splits and duration tables are
computed once per (workload, server) pair instead of once per probe.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.devices import DeviceProfile
from repro_torch.core.partition import Placement, enumerate_placements
from repro_torch.core.workload import ModelProfile
from repro_torch.serving.simulator import (
    SchedConfig,
    SimCache,
    SimResult,
    max_sustainable_qps,
)

BATCH_GRID = (32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass
class SearchResult:
    workload: str
    server: str
    placement: Placement
    sched: SchedConfig
    qps: float
    power_w: float
    p95_ms: float
    evals: int
    space_size: int
    trajectory: list


def _space(plan: str, device: DeviceProfile, o: int):
    """Feasible (m, d) coordinates for one plan at op-parallelism o."""
    cores = device.cpu.cores
    if plan == "cpu_model":
        max_m = max(cores // o, 1)
    elif plan == "cpu_sd":
        max_m = max(cores - o, 1)  # m dense threads; >=1 sparse thread of o cores
    else:
        max_m = device.accel.max_colocate if device.accel else 1
    return max_m


def _mk_sched(plan: str, device: DeviceProfile, m: int, d: int, o: int) -> SchedConfig | None:
    cores = device.cpu.cores
    if plan == "cpu_model":
        if m * o > cores:
            return None
        return SchedConfig(batch=d, m=m, o=o)
    if plan == "cpu_sd":
        sparse = (cores - m) // o
        if sparse < 1 or m < 1:
            return None
        return SchedConfig(batch=d, m=m, o=o, sd_sparse=sparse)
    if device.accel and m > device.accel.max_colocate:
        return None
    return SchedConfig(batch=d, m=m, o=o)


def gradient_search(
    profile: ModelProfile,
    device: DeviceProfile,
    query_sizes: np.ndarray,
    power_budget_w: float | None = None,
    seed: int = 0,
    o_grid: tuple[int, ...] | None = None,
    engine: str = "fast",
    cache: SimCache | None = None,
    qps_tol: float = 0.0,
) -> SearchResult:
    sla = profile.sla_ms
    if cache is None:
        cache = SimCache(query_sizes, seed)
    memo: dict[tuple, tuple[float, SimResult | None]] = {}
    trajectory: list = []

    def evaluate(pl: Placement, m: int, di: int, o: int):
        key = (pl.plan, m, di, o)
        if key in memo:
            return memo[key]
        sched = _mk_sched(pl.plan, device, m, BATCH_GRID[di], o)
        if sched is None:
            memo[key] = (0.0, None)
            return memo[key]
        qps, res = max_sustainable_qps(
            pl, device, sched, sla, query_sizes, power_budget_w, seed,
            cache=cache, engine=engine, qps_tol=qps_tol,
        )
        memo[key] = (qps, res)
        trajectory.append((pl.plan, m, BATCH_GRID[di], o, qps))
        return memo[key]

    def evaluate_frontier(pl: Placement, cands, o: int):
        """Evaluate a frontier of (m, d-index) candidates through the shared
        engine context (one SimCache: common arrival streams, splits and
        duration tables across all of them) and return the best feasible."""
        best = None
        for cm, cd in cands:
            if cd >= len(BATCH_GRID):
                continue
            cq, cr = evaluate(pl, cm, cd, o)
            if cr is None:
                continue
            if best is None or cq > best[0]:
                best = (cq, cr, cm, cd)
        return best

    def md_walk(pl: Placement, o: int):
        """Gradient walk over the (m, d) grid for one op-parallelism."""
        m, di = 1, 0
        qps, res = evaluate(pl, m, di, o)
        while True:
            best = evaluate_frontier(
                pl, [(m + 1, di), (m, di + 1), (m + 1, di + 1)], o)
            if best is None or best[0] <= qps:
                return qps, res, m, di
            qps, res, m, di = best

    best: SearchResult | None = None
    space_size = 0
    for pl in enumerate_placements(profile, device):
        if pl.plan in ("cpu_model", "cpu_sd"):
            grid = o_grid or (1, 2, 4, 5, 10)
        else:
            grid = o_grid or (1, 2)  # host-pool workers for the accel plans
        prev_peak = -1.0
        for o in grid:
            space_size += _space(pl.plan, device, o) * len(BATCH_GRID)
            qps, res, m, di = md_walk(pl, o)
            if res is not None and (best is None or qps > best.qps):
                best = SearchResult(
                    workload=profile.name,
                    server=device.name,
                    placement=pl,
                    sched=_mk_sched(pl.plan, device, m, BATCH_GRID[di], o),
                    qps=qps,
                    power_w=res.avg_power_w,
                    p95_ms=res.p95_ms,
                    evals=0,
                    space_size=0,
                    trajectory=[],
                )
            if qps < prev_peak:  # outer-loop early stop (Algorithm 1)
                break
            prev_peak = qps
    if best is None:
        # workload infeasible on this server at any configuration
        best = SearchResult(profile.name, device.name,
                            enumerate_placements(profile, device)[0],
                            SchedConfig(batch=8, m=1), 0.0,
                            device.idle_power_w, float("inf"), 0, 0, [])
    best.evals = len(memo)
    best.space_size = max(space_size, 1)
    best.trajectory = trajectory
    return best
