"""Offline profiling stage: build the workload-classification table.

For every (workload, server-type) pair, run the gradient-based task-
scheduling search and record the efficiency tuple (QPS_{m,h}, Power_{m,h})
— paper Fig. 9(b). The provisioned power budget recorded is the server's
peak power envelope (what the datacenter must budget when the server is
activated), while the measured average power at peak QPS is kept for the
energy-efficiency (QPS/W) rankings of Fig. 15.

Profiled pairs persist through :mod:`repro_torch.core.profile_cache`
(``artifacts/profiles_torch/*.json``, keyed by workload/server fingerprints,
seed, grids and the query-size sample), so cluster provisioning, examples
and benchmarks re-search a cell only when something that affects its
result changed; ``build_table(cache=False)`` forces recomputation and
``profile_cache.invalidate()`` clears the store.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core import profile_cache
from repro_torch.core.cluster import EfficiencyTable
from repro_torch.core.devices import DEFAULT_AVAILABILITY, SERVER_TYPES, DeviceProfile
from repro_torch.core.gradient_search import BATCH_GRID, SearchResult, gradient_search
from repro_torch.core.workload import ModelProfile


# Relative throughput tolerance for the bisection early-stop in provisioning-
# table builds.  The cluster LP consumes each cell as one aggregate QPS
# number and the diurnal loads carry >= 5% over-provision headroom, so a 1%
# one-sided bracket error is noise there — and it saves the final bisection
# probes of every (workload, server) search.  Everywhere results are compared
# bit-exactly (engine equivalence tests, BENCH_search.json) the default
# stays ``qps_tol=0`` (see docs/cluster_serving.md).
TABLE_QPS_TOL = 0.01


def default_query_sizes(n: int = 600, seed: int = 0) -> np.ndarray:
    """Paper Fig. 2b query-size distribution."""
    r = np.random.default_rng(seed)
    return np.clip(r.lognormal(np.log(64), 1.1, n).astype(np.int64), 1, 1024)


@dataclasses.dataclass
class ProfiledPair:
    workload: str
    server: str
    qps: float
    avg_power_w: float
    provisioned_power_w: float
    plan: str
    m: int
    d: int
    o: int
    sd_sparse: int
    p95_ms: float
    evals: int
    space_size: int
    # Multi-tenant interference dilation baked into qps/p95_ms (1.0 = solo;
    # see perfmodel.colocation_dilation). Solo records omit/keep the default
    # so every pre-existing cached profile loads unchanged.
    dilation: float = 1.0


def profile_pair(profile: ModelProfile, device: DeviceProfile,
                 query_sizes: np.ndarray | None = None, seed: int = 0,
                 engine: str = "fast", use_cache: bool = True,
                 o_grid: tuple[int, ...] | None = None,
                 qps_tol: float = TABLE_QPS_TOL) -> ProfiledPair:
    qs = query_sizes if query_sizes is not None else default_query_sizes()
    key = None
    if use_cache:
        key = profile_cache.pair_key("hercules", profile, device, qs,
                                     seed=seed, o_grid=o_grid,
                                     batch_grid=BATCH_GRID, qps_tol=qps_tol,
                                     engine=engine)
        rec = profile_cache.load("hercules", profile.name, device.name, key)
        if rec is not None:
            return ProfiledPair(**rec)
    r: SearchResult = gradient_search(profile, device, qs, seed=seed,
                                      o_grid=o_grid, engine=engine,
                                      qps_tol=qps_tol)
    s = r.sched
    pair = ProfiledPair(
        workload=profile.name, server=device.name, qps=r.qps,
        avg_power_w=r.power_w, provisioned_power_w=device.peak_power_w,
        plan=r.placement.plan, m=s.m, d=s.batch, o=s.o, sd_sparse=s.sd_sparse,
        p95_ms=r.p95_ms, evals=r.evals, space_size=r.space_size,
    )
    if use_cache:
        profile_cache.store("hercules", profile.name, device.name, key,
                            dataclasses.asdict(pair))
    return pair


def derated_device(device: DeviceProfile, co_pressures) -> DeviceProfile:
    """The device as a co-located victim sees it: every shared resource's
    bandwidth/throughput scaled by ``1 - u`` where ``u`` is the co-resident
    tenants' aggregate pressure on that resource (capped at
    ``perfmodel.COLOC_UTIL_CAP``).  Per-core outstanding-miss limits are
    per-thread properties and are *not* derated — contention lives on the
    shared bus / engine / link."""
    from repro_torch.core import perfmodel

    u = {r: min(sum(max(p.get(r, 0.0), 0.0) for p in co_pressures),
                perfmodel.COLOC_UTIL_CAP)
         for r in perfmodel.PRESSURE_RESOURCES}
    mem = device.mem
    # gather bandwidth is modeled as bw_gbs * gather_eff, so the gather
    # derate is applied on top of (divided by) the stream derate
    mem2 = dataclasses.replace(
        mem, bw_gbs=mem.bw_gbs * (1.0 - u["stream"]),
        gather_eff=mem.gather_eff * (1.0 - u["gather"])
        / max(1.0 - u["stream"], 1e-9))
    acc2 = device.accel
    if acc2 is not None:
        # MPS-style slot time-sharing slows kernels and HBM alike; the host
        # link is a separately contended resource
        acc2 = dataclasses.replace(
            acc2, peak_gflops=acc2.peak_gflops * (1.0 - u["engine"]),
            hbm_gbs=acc2.hbm_gbs * (1.0 - u["engine"]),
            link_gbs=acc2.link_gbs * (1.0 - u["link"]))
    return dataclasses.replace(device, mem=mem2, accel=acc2)


def profile_colocated(profile: ModelProfile, device: DeviceProfile,
                      co_profiles: tuple[ModelProfile, ...],
                      query_sizes: np.ndarray | None = None, seed: int = 0,
                      engine: str = "fast", use_cache: bool = True,
                      o_grid: tuple[int, ...] | None = None,
                      qps_tol: float = TABLE_QPS_TOL) -> ProfiledPair:
    """Profile `profile` on `device` with `co_profiles` co-resident.

    Each co-tenant's pressure on the shared resources is measured at its
    *fair-share* operating point (its solo peak QPS divided by the number
    of tenants sharing the machine,
    :func:`repro_torch.core.perfmodel.tenant_pressure`); the victim is then
    re-searched on the contention-derated device (:func:`derated_device`),
    so the co-located record is a real latency-bounded operating point —
    its ``p95_ms`` meets the victim's SLA whenever the search is feasible,
    and ``qps == 0`` marks an inadmissible packing.  ``dilation`` is the
    resulting duration inflation ``solo_qps / coloc_qps`` (clamped >= 1 so
    adding a tenant never shortens durations).  Cached under a coloc-keyed
    entry (solo cache entries are untouched); an empty co-set returns the
    solo record bit-identically.
    """
    from repro_torch.core import perfmodel
    from repro_torch.core.gradient_search import gradient_search

    qs = query_sizes if query_sizes is not None else default_query_sizes()
    base = profile_pair(profile, device, qs, seed=seed, engine=engine,
                        use_cache=use_cache, o_grid=o_grid, qps_tol=qps_tol)
    if not co_profiles:
        return base
    co_fps = tuple(
        profile_cache._fingerprint((co.name, co.ops, co.table_gb,
                                    co.weight_gb, co.sla_ms, co.zipf_alpha))
        for co in co_profiles)
    key = None
    if use_cache:
        key = profile_cache.pair_key(
            "hercules", profile, device, qs, seed=seed, o_grid=o_grid,
            batch_grid=BATCH_GRID, qps_tol=qps_tol, engine=engine,
            coloc=co_fps)
        rec = profile_cache.load("hercules", profile.name, device.name, key)
        if rec is not None:
            return ProfiledPair(**rec)
    mean_items = float(np.mean(qs))
    share = 1.0 / (len(co_profiles) + 1)
    pressures = []
    for co in co_profiles:
        co_base = profile_pair(co, device, qs, seed=seed, engine=engine,
                               use_cache=use_cache, o_grid=o_grid,
                               qps_tol=qps_tol)
        pressures.append(perfmodel.tenant_pressure(
            co, device, co_base.qps * share, mean_items))
    r = gradient_search(profile, derated_device(device, pressures), qs,
                        seed=seed, o_grid=o_grid, engine=engine,
                        qps_tol=qps_tol)
    qps_c = min(r.qps, base.qps)
    dil = base.qps / qps_c if qps_c > 0.0 else float("inf")
    s = r.sched
    pair = dataclasses.replace(
        base, qps=qps_c, p95_ms=r.p95_ms, avg_power_w=r.power_w,
        plan=r.placement.plan, m=s.m, d=s.batch, o=s.o,
        sd_sparse=s.sd_sparse, evals=r.evals, space_size=r.space_size,
        dilation=dil)
    if use_cache:
        profile_cache.store("hercules", profile.name, device.name, key,
                            dataclasses.asdict(pair))
    return pair


def build_table(
    profiles: dict[str, ModelProfile],
    servers: dict[str, DeviceProfile] | None = None,
    availability: dict[str, int] | None = None,
    cache: bool | str = True,
    query_sizes: np.ndarray | None = None,
    verbose: bool = False,
    seed: int = 0,
    engine: str = "fast",
    qps_tol: float = TABLE_QPS_TOL,
) -> tuple[EfficiencyTable, dict]:
    """Profile all pairs (cached per pair); returns the table + raw records.

    ``cache``: truthy -> hit/update the persistent per-pair profile cache;
    a string additionally writes the aggregate records to
    ``artifacts/profiles_torch/tables/<cache>`` for inspection.

    Table builds run the throughput bisection with ``qps_tol`` early-stop
    (default 1% — tolerable for provisioning); pass
    ``qps_tol=0.0`` for bit-exact cells.
    """
    servers = servers or SERVER_TYPES
    availability = availability or DEFAULT_AVAILABILITY
    qs = query_sizes if query_sizes is not None else default_query_sizes()
    records: dict[str, dict] = {}
    for wname, prof in profiles.items():
        for sname, dev in servers.items():
            pair = profile_pair(prof, dev, qs, seed=seed, engine=engine,
                                use_cache=bool(cache), qps_tol=qps_tol)
            records[f"{wname}|{sname}"] = dataclasses.asdict(pair)
            if verbose:
                print(f"profiled {wname}|{sname}: qps={pair.qps:.0f} "
                      f"plan={pair.plan}", flush=True)
    if isinstance(cache, str):
        agg = profile_cache.PROFILE_DIR / "tables" / cache
        agg.parent.mkdir(parents=True, exist_ok=True)
        agg.write_text(json.dumps(records, indent=1))

    snames = list(servers)
    wnames = list(profiles)
    qps = np.zeros((len(snames), len(wnames)))
    power = np.zeros_like(qps)
    for i, s in enumerate(snames):
        for j, w in enumerate(wnames):
            rec = records[f"{w}|{s}"]
            qps[i, j] = rec["qps"]
            power[i, j] = rec["provisioned_power_w"]
    table = EfficiencyTable(
        servers=tuple(snames), workloads=tuple(wnames), qps=qps, power=power,
        avail=np.array([availability[s] for s in snames], np.int64),
    )
    return table, records
