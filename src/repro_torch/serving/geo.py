"""Geo-distributed multi-region serving with follow-the-sun provisioning.

Hercules provisions one datacenter against one diurnal curve; its saving
argument compounds when regions peak out of phase.  This module puts a
region layer on top of the scenario zoo (the result the paper never had):

- :func:`compile_geo_scenario` expands a :class:`ScenarioSpec` with
  ``regions`` into one *single-DC* compiled day per region — each region
  re-uses the spec's workload curves on its local clock
  (``RegionSpec.phase_hours`` shifts ``peak_hour``/``shoulder_hour``),
  with its own topology, load scale and decorrelated trace seeds — plus a
  :class:`GeoNetwork` resolved from the spec's ``links`` (per-direction
  capacity and RTT);
- :func:`plan_spill` decides, per interval, how much of each workload's
  offered load each region ships to its neighbours: a Helix-style joint
  LP (:func:`repro_torch.core.lp.solve_geo_spill`) over per-region fractional
  server counts and directed spill rates, minimizing global provisioned
  power under per-region pool limits, per-link capacity, and an
  RTT-vs-SLA budget (a workload may only spill over a link whose RTT fits
  inside ``rtt_budget_frac`` of its SLA — Hera's SLA-aware spill rather
  than greedy offload); a deterministic water-fill fallback covers
  ``placement="greedy"`` and missing scipy;
- :func:`simulate_geo_day` serves each region's *post-spill* day through
  the unchanged query-granular :func:`simulate_cluster_day` — so each
  region's :class:`StatefulProvisioner` re-solves against the flattened
  load (follow-the-sun: the global fleet peak de-synchronizes) — then
  attributes every served query back to its origin region
  (:func:`repro_torch.serving.router.split_stream_by_share` over the interval's
  origin shares) and adds the link RTT to spilled queries' latency
  exactly once.  ``mode="isolated"`` is the per-region-isolated Hercules
  baseline the bench's ``geo_day`` record compares against.

Region-scale incidents arrive as scenario events: ``region_partition``
severs every link touching a region for an interval window (local-only
serving), ``region_drain`` evacuates a whole DC — its keepable load ramps
to zero and the remainder force-spills over surviving links, with
make-before-break power accounting on both sides (the receiving regions
provision *before* the source stops serving; the source's removed servers
pay their drain power through each region's ``StatefulProvisioner``).

Everything is deterministic: spill plans depend only on compiled traces,
static capacities and the event timeline; attribution uses the router's
golden-ratio interleave with a ``(region, workload, interval)``-derived
sequence offset.  The reference's copy of this file is in
``repro.analysis``'s determinism-lint scope.  See ``docs/geo_serving.md``.
The port's entry points take a ``device`` keyword: where the regions'
``event_core`` fleet groups run (``"cuda"`` by default, ``"cpu"`` for the
plain version).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.types import resolve_device
from repro_torch.core.lp import solve_geo_spill
from repro_torch.serving.cluster_runtime import DayResult, simulate_cluster_day
from repro_torch.serving.router import split_stream_by_share
from repro_torch.serving.scenarios import (
    EVENT_TYPES,
    GEO_EVENT_KINDS,
    CompiledScenario,
    ScenarioError,
    ScenarioSpec,
    compile_scenario,
)

GEO_MODES = ("follow_sun", "isolated")


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    """Knobs of the geo spill planner."""

    #: "lp" = Helix-style joint LP (scipy HiGHS) with the water-fill as a
    #: fallback; "greedy" = the deterministic water-fill directly
    placement: str = "lp"
    #: a workload may spill over a link only if the link RTT fits inside
    #: this fraction of its SLA (spilled latency = remote service + RTT
    #: must still meet the SLA with headroom for the serving tail)
    rtt_budget_frac: float = 0.5
    #: tiny RTT-weighted cost on spill in the LP objective: breaks power
    #: ties toward local serving / the shortest feasible link
    spill_penalty: float = 1e-6
    #: plan entries below this rate (QPS) are zeroed (LP solver noise)
    min_spill_qps: float = 0.1


@dataclasses.dataclass
class GeoNetwork:
    """The inter-region network resolved to directed-pair capacities.

    ``LinkSpec.capacity_frac`` is declared relative to the *smaller*
    endpoint's total best-case fleet capacity (summed over workloads), so
    the resolved ``cap_qps`` scales with the topology.  Links are
    bidirectional: each :class:`LinkSpec` yields two directed pairs with
    the same RTT and per-direction capacity.
    """

    regions: tuple[str, ...]
    rtt_ms: dict[tuple[int, int], float]     # directed (origin, dest)
    cap_qps: dict[tuple[int, int], float]

    @staticmethod
    def build(spec: ScenarioSpec,
              days: dict[str, CompiledScenario]) -> "GeoNetwork":
        names = tuple(r.name for r in spec.regions)
        total = {n: float(days[n].table.fleet_capacity().sum())
                 for n in names}
        rtt: dict[tuple[int, int], float] = {}
        cap: dict[tuple[int, int], float] = {}
        for li in spec.links or ():
            i, j = names.index(li.a), names.index(li.b)
            c = li.capacity_frac * min(total[li.a], total[li.b])
            for p in ((i, j), (j, i)):
                rtt[p] = li.rtt_ms
                cap[p] = c
        return GeoNetwork(regions=names, rtt_ms=rtt, cap_qps=cap)

    def pairs(self) -> list[tuple[int, int]]:
        return sorted(self.rtt_ms)

    def active_pairs(self, severed: list[int],
                     inbound_blocked: list[int]) -> list[tuple[int, int]]:
        """Directed pairs usable this interval: neither endpoint under a
        partition, destination not mid-evacuation."""
        return [p for p in self.pairs()
                if p[0] not in severed and p[1] not in severed
                and p[1] not in inbound_blocked]


@dataclasses.dataclass
class CompiledGeoScenario:
    """A geo spec resolved to one compiled single-DC day per region plus
    the network; ``run`` plans the spill and serves the post-spill days."""

    spec: ScenarioSpec
    days: dict[str, CompiledScenario]       # region name -> base day
    network: GeoNetwork
    partitions: list[tuple[str, int, int]]  # (region, start, end)
    drains: list[tuple[str, int, int]]      # (region, at, ramp)

    @property
    def region_names(self) -> tuple[str, ...]:
        return tuple(r.name for r in self.spec.regions)

    def run(self, policy: str | None = None, mode: str = "follow_sun",
            geo: GeoConfig | None = None,
            device: str | torch.device = "cuda") -> "GeoDayResult":
        return simulate_geo_day(self, policy=policy or self.spec.policy,
                                mode=mode, geo=geo, device=device)


def compile_geo_scenario(spec: ScenarioSpec,
                         verbose: bool = False) -> CompiledGeoScenario:
    """Expand a spec with ``regions`` into per-region compiled days.

    Each region gets the spec's workloads on its local clock
    (``peak_hour``/``shoulder_hour`` shifted by ``phase_hours`` mod 24),
    its load scale, decorrelated trace seeds, and its topology overrides;
    non-geo events apply to every region's local day, geo events
    (``region_partition``/``region_drain``) are consumed here.
    """
    if spec.regions is None:
        raise ScenarioError(
            f"scenario {spec.name!r}: compile_geo_scenario needs regions")
    local_events = tuple(ev for ev in spec.events
                         if ev.kind not in GEO_EVENT_KINDS)
    days: dict[str, CompiledScenario] = {}
    for r in spec.regions:
        workloads = tuple(dataclasses.replace(
            w,
            peak_hour=(w.peak_hour + r.phase_hours) % 24.0,
            shoulder_hour=(w.shoulder_hour + r.phase_hours) % 24.0,
            load_frac=w.load_frac * r.load_scale,
            trace_seed=w.trace_seed + r.trace_seed_offset,
        ) for w in spec.workloads)
        rspec = dataclasses.replace(
            spec, name=f"{spec.name}/{r.name}", workloads=workloads,
            servers=r.servers if r.servers is not None else spec.servers,
            availability=r.availability if r.availability is not None
            else spec.availability,
            events=local_events, regions=None, links=None)
        days[r.name] = compile_scenario(rspec, verbose=verbose)
    comp = CompiledGeoScenario(
        spec=spec, days=days, network=GeoNetwork.build(spec, days),
        partitions=[], drains=[])
    runtime: dict = {}
    for ev in spec.events:
        if ev.kind in GEO_EVENT_KINDS:
            EVENT_TYPES[ev.kind].apply(comp, runtime, ev.params)
    return comp


# ---------------------------------------------------------------------------
# spill planning
# ---------------------------------------------------------------------------


def _drain_gates(comp: CompiledGeoScenario) -> np.ndarray:
    """[R, T] keepable-load gates from ``region_drain`` events (1 = keep
    everything, ramping linearly to 0 over the drain window)."""
    names = comp.region_names
    T = comp.spec.n_steps
    gate = np.ones((len(names), T))
    for (rname, at, ramp) in comp.drains:
        g = np.ones(T)
        end = min(at + ramp, T)
        g[at:end] = 1.0 - (np.arange(end - at) + 1) / ramp
        g[end:] = 0.0
        gate[names.index(rname)] *= g
    return gate


def _severed_at(comp: CompiledGeoScenario, t: int) -> list[int]:
    names = comp.region_names
    out = []
    for (rname, start, end) in comp.partitions:
        if start <= t < end:
            i = names.index(rname)
            if i not in out:
                out.append(i)
    return out


def _greedy_spill(loads: np.ndarray, must: np.ndarray,
                  active: list[tuple[int, int]],
                  allowed: dict[tuple[int, int], np.ndarray],
                  net: GeoNetwork, caps: list[np.ndarray],
                  ) -> tuple[dict[tuple[int, int], np.ndarray], bool]:
    """Deterministic water-fill spill for one interval.

    Forced evacuation first (lowest-RTT surviving link wins), then a few
    bounded sweeps that move load from the highest-utilization region to
    its least-utilized allowed neighbour until utilizations are within a
    band.  Utilization is the sum of per-workload load fractions against
    the region's best-case fleet capacity — a proxy that errs toward
    under-filling the receiver.  Returns ``(spill, ok)``; ``ok=False``
    when a forced evacuation could not be placed.
    """
    R, M = loads.shape
    spill = {p: np.zeros(M) for p in active}
    link_left = {p: net.cap_qps[p] for p in active}
    served = loads.copy()
    order = sorted(active, key=lambda p: (net.rtt_ms[p], p))

    def util(r: int) -> float:
        return float((served[r] / np.maximum(caps[r], 1e-9)).sum())

    ok = True
    for r in range(R):
        for m in range(M):
            need = float(must[r, m])
            for p in order:
                if need <= 1e-9:
                    break
                if p[0] != r or not allowed[p][m]:
                    continue
                j = p[1]
                head = max(0.0, (1.0 - util(j)) * float(caps[j][m]))
                move = min(need, link_left[p], head)
                if move <= 0.0:
                    continue
                spill[p][m] += move
                link_left[p] -= move
                served[r, m] -= move
                served[j, m] += move
                need -= move
            if need > 1e-6:
                ok = False
    for _ in range(8):  # bounded equalization sweeps
        us = [util(r) for r in range(R)]
        donor = int(np.argmax(us))
        cands = [p for p in order if p[0] == donor and link_left[p] > 0.0]
        if not cands or us[donor] <= 0.0:
            break
        recip = min(cands, key=lambda p: (us[p[1]], p))
        j = recip[1]
        du = (us[donor] - us[j]) / 2.0
        if du < 0.02:
            break
        frac = min(du / us[donor], 1.0)
        for m in range(M):
            if not allowed[recip][m]:
                continue
            move = min(frac * float(served[donor, m]), link_left[recip])
            if move <= 0.0:
                continue
            spill[recip][m] += move
            link_left[recip] -= move
            served[donor, m] -= move
            served[j, m] += move
    return spill, ok


def plan_spill(comp: CompiledGeoScenario, geo: GeoConfig | None = None,
               ) -> tuple[list[dict[tuple[int, int], np.ndarray]],
                          list[str], bool]:
    """Per-interval spill plan for the whole day.

    Returns ``(plan, events, ok)``: ``plan[t]`` maps directed region pairs
    to per-workload spill rates (QPS), ``events`` narrates fallbacks and
    failed evacuations, ``ok`` is False when some forced evacuation could
    not be placed.  The plan depends only on compiled traces, static
    capacities and the event timeline — not on which policy serves it —
    so follow-the-sun and any policy comparison share one plan (CRN).
    """
    geo = geo or GeoConfig()
    if geo.placement not in ("lp", "greedy"):
        raise ValueError(f"unknown placement {geo.placement!r}; "
                         "expected 'lp' or 'greedy'")
    names = comp.region_names
    days = [comp.days[n] for n in names]
    R = len(names)
    M, T = days[0].traces.shape
    loads = np.stack([np.asarray(d.traces, dtype=float) for d in days])
    gate = _drain_gates(comp)
    slas = np.array([days[0].profiles[w].sla_ms
                     for w in days[0].table.workloads])
    qps_r = [d.table.qps for d in days]
    power_r = [d.table.power for d in days]
    avail_r = [d.table.avail for d in days]
    caps = [d.table.fleet_capacity() for d in days]
    # plan under one shared over-provision rate (the most conservative
    # region's): per-region R differences are curve-jitter artifacts the
    # LP would otherwise arbitrage into massive no-win spill
    over = float(np.max([d.overprovision for d in days]))
    budget_ok = {p: comp.network.rtt_ms[p] <= geo.rtt_budget_frac * slas
                 for p in comp.network.pairs()}

    plan: list[dict[tuple[int, int], np.ndarray]] = []
    events: list[str] = []
    ok = True
    for t in range(T):
        lt = loads[:, :, t]
        must = lt * (1.0 - gate[:, t])[:, None]
        severed = _severed_at(comp, t)
        inbound_blocked = [r for r in range(R) if gate[r, t] < 1.0]
        active = comp.network.active_pairs(severed, inbound_blocked)
        allowed = {p: budget_ok[p] for p in active}
        if not active:
            if float(must.sum()) > 1e-6:
                ok = False
                events.append(f"t={t}: evacuation ordered but no usable "
                              "links (partitioned or isolated)")
            plan.append({})
            continue
        spill = None
        if geo.placement == "lp":
            sol = solve_geo_spill(
                lt, qps_r, power_r, avail_r, allowed,
                {p: comp.network.cap_qps[p] for p in active},
                {p: comp.network.rtt_ms[p] for p in active},
                must_spill=must, overprovision=over,
                spill_penalty=geo.spill_penalty)
            if sol is not None:
                spill = sol[0]
        if spill is None:
            if geo.placement == "lp":
                events.append(f"t={t}: spill LP unavailable/infeasible -> "
                              "greedy water-fill")
            spill, gok = _greedy_spill(lt, must, active, allowed,
                                       comp.network, caps)
            if not gok:
                ok = False
                events.append(f"t={t}: forced evacuation could not be "
                              "fully placed")
        clean: dict[tuple[int, int], np.ndarray] = {}
        for p in active:
            s = np.asarray(spill.get(p, np.zeros(M)), dtype=float)
            s = np.where(s >= geo.min_spill_qps, s, 0.0)
            if float(s.sum()) > 0.0:
                clean[p] = s
        plan.append(clean)
    return plan, events, ok


# ---------------------------------------------------------------------------
# the geo day
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeoDayResult:
    """Typed result of :func:`simulate_geo_day`.

    ``regions`` holds each region's full (serving-side) :class:`DayResult`
    on its post-spill load; ``origin`` re-attributes every served query to
    the region whose users issued it — spilled queries carry their link
    RTT — which is where SLA attainment is judged.  ``power`` is the
    global fleet series (sum over regions, transition drain included).
    """

    scenario: str
    policy: str
    mode: str
    region_names: tuple[str, ...]
    regions: dict[str, DayResult]
    origin: dict[str, dict]
    power: np.ndarray
    peak_power_w: float
    avg_power_w: float
    feasible: bool
    all_meet_sla: bool
    all_intervals_meet_sla: bool
    n_spilled: int           # spilled queries among the simulated streams
    spilled_qps_mean: float  # day-mean total planned spill rate
    lost_qps_mean: float     # day-mean evacuated-but-unplaceable rate
    events: list[str]

    def to_dict(self) -> dict:
        """JSON-safe summary (region day series flattened to scalars plus
        the global power series)."""
        return {
            "scenario": self.scenario,
            "policy": self.policy,
            "mode": self.mode,
            "region_names": list(self.region_names),
            "regions": {
                name: {
                    "peak_power_w": r.peak_power_w,
                    "avg_power_w": r.avg_power_w,
                    "peak_capacity": r.peak_capacity,
                    "feasible": r.feasible,
                    "all_meet_sla": r.all_meet_sla,
                    "total_churn": r.total_churn,
                } for name, r in self.regions.items()},
            "origin": self.origin,
            "power_w": [float(p) for p in self.power],
            "peak_power_w": self.peak_power_w,
            "avg_power_w": self.avg_power_w,
            "feasible": self.feasible,
            "all_meet_sla": self.all_meet_sla,
            "all_intervals_meet_sla": self.all_intervals_meet_sla,
            "n_spilled": self.n_spilled,
            "spilled_qps_mean": self.spilled_qps_mean,
            "lost_qps_mean": self.lost_qps_mean,
            "events": list(self.events),
        }


def simulate_geo_day(comp: CompiledGeoScenario, policy: str = "hercules",
                     mode: str = "follow_sun",
                     geo: GeoConfig | None = None,
                     device: str | torch.device = "cuda") -> GeoDayResult:
    """Serve the geo day: plan the spill, serve each region's post-spill
    load at query granularity, attribute queries back to their origins.

    ``mode="follow_sun"`` runs the spill planner; ``mode="isolated"`` is
    the per-region-isolated baseline — no links, every region serves its
    own offered load (a ``region_drain``'s evacuated load then has nowhere
    to go and is reported lost).  Both modes provision each region with
    its base-curve over-provision rate, so the comparison isolates the
    effect of the spill itself.  ``device`` is passed to each region's
    :func:`simulate_cluster_day`.
    """
    device = resolve_device(device)
    geo = geo or GeoConfig()
    if mode not in GEO_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{'/'.join(GEO_MODES)}")
    names = comp.region_names
    days = [comp.days[n] for n in names]
    R = len(names)
    M, T = days[0].traces.shape
    wl = days[0].table.workloads
    events: list[str] = []
    if mode == "follow_sun":
        plan, plan_events, plan_ok = plan_spill(comp, geo)
        events.extend(plan_events)
    else:
        plan, plan_ok = [{} for _ in range(T)], True

    loads = np.stack([np.asarray(d.traces, dtype=float) for d in days])
    gate = _drain_gates(comp)
    evac = loads * (1.0 - gate[:, None, :])
    out = np.zeros((R, M, T))
    inc = np.zeros((R, M, T))
    for t, sp in enumerate(plan):
        for (i, j), s in sorted(sp.items()):
            out[i, :, t] += s
            inc[j, :, t] += s
    # an evacuated DC cannot serve what it failed to ship: the shortfall
    # is lost load, not locally served load
    lost = np.maximum(evac - out, 0.0)
    lost[lost < 1e-6] = 0.0
    served = loads - np.maximum(out, evac) + inc
    # a fully-spilled cell leaves float residue behind; a sub-micro-QPS
    # trace is an idle interval, not a provisioning target
    served[served < 1e-6] = 0.0
    if float(lost.sum()) > 1e-6:
        plan_ok = False
        events.append("evacuated load could not be placed: "
                      f"{float(lost.sum()):.0f} qps-intervals lost")

    # serve each region's post-spill day (make-before-break transitions and
    # drain power are the region provisioner's own accounting).  Each region
    # keeps the over-provision rate derived from its *base* curves — spill
    # and drains are disruptions the provisioner absorbs, not forecasts
    # (re-deriving R from a post-spill trace would read a drain landing as
    # a load-growth rate and inflate the provisioning target)
    results: list[DayResult] = []
    for r in range(R):
        din = dataclasses.replace(days[r].inputs, traces=served[r])
        cfg = dataclasses.replace(days[r].config, collect_latencies=True)
        results.append(simulate_cluster_day(din, policy=policy, config=cfg,
                                            device=device))
        for ev in results[-1].events:
            events.append(f"{names[r]}: {ev}")

    # origin attribution: split each destination's measured stream by the
    # interval's origin shares (golden-ratio interleave, deterministic in
    # (dest, workload, interval)); spilled queries pay the link RTT once
    origin_lat: list[list[list[np.ndarray]]] = \
        [[[] for _ in range(M)] for _ in range(R)]
    origin_lat_t: list[list[list[np.ndarray | None]]] = \
        [[[None] * T for _ in range(M)] for _ in range(R)]
    n_spilled = np.zeros((R, M), np.int64)
    for j in range(R):
        lats = results[j].latencies
        for m in range(M):
            for t in range(T):
                lat = None if lats is None else lats[m][t]
                if lat is None or len(lat) == 0:
                    continue
                shares = np.zeros(R)
                shares[j] = max(served[j, m, t] - inc[j, m, t], 0.0)
                for (i, j2), s in plan[t].items():
                    if j2 == j:
                        shares[i] += s[m]
                if shares.sum() <= 0.0:
                    shares[j] = 1.0
                seq = (j * M + m) * T + t
                assign = split_stream_by_share(len(lat), shares, seq=seq)
                for i in range(R):
                    sel = lat[assign == i]
                    if len(sel) == 0:
                        continue
                    if i != j:
                        sel = sel + comp.network.rtt_ms[(i, j)] / 1e3
                        n_spilled[i, m] += len(sel)
                    origin_lat[i][m].append(sel)
                    prev = origin_lat_t[i][m][t]
                    origin_lat_t[i][m][t] = sel if prev is None \
                        else np.concatenate([prev, sel])

    # origin-view SLA attainment (the numbers the geo gate judges)
    origin: dict[str, dict] = {}
    all_meet = True
    all_intervals = True
    for r in range(R):
        sq = days[r].config.sla_quantile
        per_wl: dict[str, dict] = {}
        for m, name in enumerate(wl):
            sla = days[r].profiles[name].sla_ms
            parts = origin_lat[r][m]
            if parts:
                lat_ms = np.concatenate(parts) * 1e3
            else:
                lat_ms = np.array([np.inf]) if float(loads[r, m].sum()) > 0 \
                    and float(lost[r, m].sum()) > 1e-6 else np.array([0.0])
            p50, p95, p99 = (float(v) for v in
                             np.percentile(lat_ms, (50, 95, 99)))
            q = float(np.quantile(lat_ms, sq))
            meets = bool(q <= sla)
            met_t, n_meas = 0, 0
            for t in range(T):
                lt = origin_lat_t[r][m][t]
                if lt is None:
                    continue
                n_meas += 1
                met_t += bool(float(np.quantile(lt * 1e3, sq)) <= sla)
            every = bool(n_meas == met_t)
            all_meet &= meets
            all_intervals &= every
            per_wl[name] = {
                "sla_ms": sla, "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
                "sla_attainment": float(np.mean(lat_ms <= sla)),
                "meets_sla": meets,
                "interval_sla_met_frac":
                    float(met_t / n_meas) if n_meas else 0.0,
                "meets_every_interval": every,
                "n_queries": int(sum(len(p) for p in parts)),
                "n_spilled": int(n_spilled[r, m]),
            }
        origin[names[r]] = per_wl

    power = np.sum([res.power for res in results], axis=0)
    feasible = plan_ok and all(res.feasible for res in results)
    return GeoDayResult(
        scenario=comp.spec.name,
        policy=policy,
        mode=mode,
        region_names=names,
        regions={names[r]: results[r] for r in range(R)},
        origin=origin,
        power=power,
        peak_power_w=float(power.max()),
        avg_power_w=float(power.mean()),
        feasible=bool(feasible),
        all_meet_sla=bool(all_meet and feasible),
        all_intervals_meet_sla=bool(all_intervals and feasible),
        n_spilled=int(n_spilled.sum()),
        spilled_qps_mean=float(out.sum(axis=(0, 1)).mean()),
        lost_qps_mean=float(lost.sum(axis=(0, 1)).mean()),
        events=events,
    )
