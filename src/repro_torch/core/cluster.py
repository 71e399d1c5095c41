"""Cluster-level scheduling (paper §IV-C, §VI-C).

Three provisioning policies over the workload-classification table
(efficiency tuples):

- ``nh``       : heterogeneity-oblivious — activates servers in a random
                 order until each workload's load is covered.
- ``greedy``   : Paragon/Quasar-style — per workload, activates the
                 best-ranked (QPS/W) available server type; contention
                 between workloads for the same type is resolved in
                 arbitrary (workload-index) order, which is exactly the
                 failure mode of Fig. 8.
- ``hercules`` : the paper's contribution — global LP (Eq. 1-3) minimizing
                 total provisioned power, then integer repair.

``provision_day`` runs a policy across a diurnal trace and reports the
capacity (activated servers) and provisioned-power time series.  It
re-solves every interval statelessly; :class:`StatefulProvisioner` is the
online form — allocations carry over between intervals, allocation deltas
incur model-load/drain delays, a hysteresis band suppresses re-solving
(and thrashing) while the load stays near what the fleet was sized for,
and mid-day server failures shrink the pool and force an elastic
re-provision (`repro_torch.serving.cluster_runtime` drives actual query streams
through the result).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lp import round_and_repair, solve_relaxation


@dataclasses.dataclass(frozen=True)
class EfficiencyTable:
    """Workload classification (paper Fig. 9b): offline-profiled tuples."""

    servers: tuple[str, ...]       # H server-type names
    workloads: tuple[str, ...]     # M workload names
    qps: np.ndarray                # [H, M] latency-bounded throughput
    power: np.ndarray              # [H, M] provisioned power budget (W)
    avail: np.ndarray              # [H] available servers N_h

    def fleet_capacity(self) -> np.ndarray:
        """Best-case fleet QPS per workload ([M]): every available server
        of every type serving that workload alone.  Scenario load fractions
        (and the benchmarks' comparison fraction) are declared relative to
        this bound."""
        return (self.avail[:, None] * self.qps).sum(axis=0)

    def ranking(self, m: int, metric: str = "qps_per_watt") -> list[int]:
        """Server-type ranking for workload m (greedy scheduler input)."""
        if metric == "qps_per_watt":
            score = self.qps[:, m] / np.maximum(self.power[:, m], 1e-9)
        else:
            score = self.qps[:, m]
        return list(np.argsort(-score))

    def with_availability(self, availability: dict[str, int]) -> "EfficiencyTable":
        """The same profiled tuples under a different server pool.

        Availability only enters provisioning through the ``avail`` column
        — the per-pair (QPS, Power) tuples are properties of the hardware,
        not of how many machines a site owns — so a region (or a what-if
        sweep) that differs from an already-profiled topology only in pool
        sizes can reuse the table without re-profiling
        (``repro_torch.serving.scenarios._bundle`` takes this fast path).
        Every server type in the table must be given a count."""
        missing = [s for s in self.servers if s not in availability]
        if missing:
            raise KeyError(
                f"with_availability: no count for server type(s) "
                f"{', '.join(missing)}")
        return dataclasses.replace(
            self, avail=np.array([availability[s] for s in self.servers],
                                 np.int64))


@dataclasses.dataclass
class ProvisionResult:
    alloc: np.ndarray              # [H, M] integer server counts
    provisioned_power_w: float
    capacity: int                  # total activated servers
    feasible: bool

    @staticmethod
    def infeasible(H: int, M: int) -> "ProvisionResult":
        return ProvisionResult(np.zeros((H, M), np.int64), 0.0, 0, False)


def _power_capacity(table: EfficiencyTable, alloc: np.ndarray) -> tuple[float, int]:
    return float((alloc * table.power).sum()), int(alloc.sum())


def provision_nh(table: EfficiencyTable, load: np.ndarray,
                 overprovision: float = 0.0, seed: int = 0) -> ProvisionResult:
    rng = np.random.default_rng(seed)
    H, M = table.qps.shape
    alloc = np.zeros((H, M), np.int64)
    remaining = table.avail.astype(np.int64).copy()
    target = load * (1.0 + overprovision)
    served = np.zeros(M)
    # random server activation order, round-robin over workloads needing load
    pool = np.repeat(np.arange(H), remaining)
    rng.shuffle(pool)
    for h in pool:
        deficit = target - served
        if (deficit <= 1e-9).all():
            break
        m = int(rng.choice(np.flatnonzero(deficit > 1e-9)))
        if table.qps[h, m] <= 0:
            continue
        alloc[h, m] += 1
        served[m] += table.qps[h, m]
    if ((target - served) > 1e-9).any():
        return ProvisionResult.infeasible(H, M)
    p, c = _power_capacity(table, alloc)
    return ProvisionResult(alloc, p, c, True)


def provision_greedy(table: EfficiencyTable, load: np.ndarray,
                     overprovision: float = 0.0,
                     metric: str = "qps_per_watt") -> ProvisionResult:
    H, M = table.qps.shape
    alloc = np.zeros((H, M), np.int64)
    remaining = table.avail.astype(np.int64).copy()
    target = load * (1.0 + overprovision)
    for m in range(M):  # arbitrary workload order: the Fig. 8 deficiency
        need = target[m]
        for h in table.ranking(m, metric):
            while need > 1e-9 and remaining[h] > 0 and table.qps[h, m] > 0:
                alloc[h, m] += 1
                remaining[h] -= 1
                need -= table.qps[h, m]
            if need <= 1e-9:
                break
        if need > 1e-9:
            return ProvisionResult.infeasible(H, M)
    p, c = _power_capacity(table, alloc)
    return ProvisionResult(alloc, p, c, True)


def provision_hercules(table: EfficiencyTable, load: np.ndarray,
                       overprovision: float = 0.0) -> ProvisionResult:
    """LP relaxation + integer repair; since rounding can regress past the
    greedy integer solution on small instances, return the cheaper of the
    two feasible allocations (the LP optimum is a lower bound on both)."""
    H, M = table.qps.shape
    candidates: list[ProvisionResult] = []
    x = solve_relaxation(table.qps, table.power, load, table.avail, overprovision)
    if x is not None:
        n = round_and_repair(x, table.qps, table.power, load, table.avail,
                             overprovision)
        if n is not None:
            p, c = _power_capacity(table, n)
            candidates.append(ProvisionResult(n, p, c, True))
    g = provision_greedy(table, load, overprovision)
    if g.feasible:
        candidates.append(g)
    if not candidates:
        return ProvisionResult.infeasible(H, M)
    return min(candidates, key=lambda r: r.provisioned_power_w)


POLICIES = {
    "nh": provision_nh,
    "greedy": provision_greedy,
    "hercules": provision_hercules,
}


# ---------------------------------------------------------------------------
# stateful online provisioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransitionConfig:
    """Allocation-transition model for online (stateful) provisioning.

    A newly activated server must load model weights + embedding tables
    before it serves (``model_load_s``); a deactivated server drains its
    in-flight/handoff traffic for ``drain_s`` while still drawing power.
    With ``drain_s >= model_load_s`` transitions are make-before-break: the
    outgoing servers cover the load until the incoming ones are warm.
    ``hysteresis`` is the relative load band around the last provisioned
    point inside which the previous allocation is held (no re-solve, no
    churn) as long as it still covers the target.  ``feedback_boost`` is
    the extra relative headroom a re-solve provisions when the *achieved*
    tail violated the SLA in the previous interval (``tail_ok=False`` fed
    to :meth:`StatefulProvisioner.step`): offered load alone cannot see a
    backlog that queueing has already built, so the feedback both vetoes
    the hysteresis hold and sizes the fleet above the offered load to
    drain it.
    """

    interval_s: float = 900.0      # provisioning interval (24h / 96)
    model_load_s: float = 120.0    # weight/table load before serving starts
    drain_s: float = 150.0         # post-deactivation drain (power still drawn)
    hysteresis: float = 0.10       # relative load band that holds the alloc
    feedback_boost: float = 0.10   # extra headroom on a tail-violation resolve


@dataclasses.dataclass
class StatefulStep:
    """One interval of stateful provisioning."""

    alloc: np.ndarray              # [H, M] serving allocation this interval
    power_w: float                 # provisioned power incl. draining servers
    capacity: int                  # steady-state activated servers
    feasible: bool
    resolved: bool                 # False = hysteresis hold (no re-solve)
    added: np.ndarray              # [H, M] newly activated (loading) servers
    removed: np.ndarray            # [H, M] deactivated (draining) servers
    # multi-tenant packing (empty when the provisioner has no colocation
    # table — the defaults keep single-tenant behavior bitwise)
    coalloc: tuple = ()            # CoMachine shared machines this interval
    co_added: tuple = ()           # newly activated shared machines
    co_removed: tuple = ()         # draining shared machines

    @property
    def churn(self) -> int:
        return int(self.added.sum() + self.removed.sum()) + \
            len(self.co_added) + len(self.co_removed)


def _co_diff(new: tuple, old: tuple) -> tuple[tuple, tuple]:
    """Multiset diff of shared-machine tuples: (added, removed)."""
    remaining = list(old)
    added = []
    for c in new:
        if c in remaining:
            remaining.remove(c)
        else:
            added.append(c)
    return tuple(added), tuple(remaining)


class StatefulProvisioner:
    """Online cluster provisioning with allocation state across intervals.

    Differences from the stateless ``provision_day`` loop:

    - the previous allocation is *held* while every workload's load stays
      within the hysteresis band of the load it was sized for and the
      allocation still covers the (over-provisioned) target — single-
      interval load wiggles no longer flap servers on and off;
    - when the policy does re-solve, the allocation delta is reported as
      ``added``/``removed`` and charged for transitions: added servers draw
      power immediately but only start serving after ``model_load_s``;
      removed servers keep drawing power for ``drain_s`` while they drain;
    - ``fail()`` removes servers from the live pool *and* from the current
      allocation (elastic N_h), forcing a re-solve at the next step;
    - ``step(load, tail_ok=False)`` is the achieved-tail feedback path
      (the cluster runtime reports whether the previous interval met its
      SLAs): a violation vetoes the hysteresis hold — offered load looks
      fine while carried backlog is eating the tail — and the re-solve
      provisions ``feedback_boost`` extra headroom to drain the backlog.
    """

    def __init__(self, table: EfficiencyTable, policy: str = "hercules",
                 overprovision: float = 0.05,
                 transitions: TransitionConfig | None = None, seed: int = 0,
                 colocation=None):
        self.table = table
        self.policy = policy
        self.overprovision = overprovision
        self.transitions = transitions or TransitionConfig()
        self.seed = seed
        # optional repro_torch.core.colocation.ColocationTable: when set, every
        # re-solve is followed by the interference-aware merge pass and the
        # step carries shared machines in ``coalloc``
        self.colocation = colocation
        self.avail = table.avail.astype(np.int64).copy()
        self._rng = np.random.default_rng(seed + 101)
        H, M = table.qps.shape
        self.alloc = np.zeros((H, M), np.int64)
        self.coalloc: tuple = ()
        self._provisioned_load: np.ndarray | None = None
        self._force = True          # first step / after failure: must solve
        self._warm = True           # day starts warm: no load delay at t=0
        self.t = 0
        self.n_resolves = 0
        self.n_holds = 0
        self.n_tail_resolves = 0    # re-solves forced by tail feedback

    # -- failures ------------------------------------------------------------

    def fail(self, h: int, count: int = 1) -> list[tuple[int, int]]:
        """Remove up to ``count`` servers of type ``h`` from the pool.

        The victim is a uniformly random machine of that type, so a serving
        instance dies with probability ``serving / available`` (and its
        workload is drawn proportionally to the allocation); idle spares
        absorb the rest.  Returns the affected ``(h, m)`` cells (one entry
        per failed *serving* instance) and forces a re-solve at the next
        :meth:`step`.
        """
        victims: list = []
        for _ in range(count):
            if self.avail[h] <= 0:
                break
            co_h = [c for c in self.coalloc
                    if c.server == self.table.servers[h]]
            serving = int(self.alloc[h].sum()) + len(co_h)
            hit_serving = self._rng.random() < serving / self.avail[h]
            self.avail[h] -= 1
            if (hit_serving or serving > self.avail[h]) and serving > 0:
                if co_h:
                    # shared machines are victimized first (deterministic;
                    # a no-op when coalloc is empty, which keeps the
                    # single-tenant victim stream bitwise unchanged); one
                    # failed shared machine yields a victim for every
                    # tenant packed on it, so the entry is the CoMachine
                    c = co_h[0]
                    i = next(j for j, x in enumerate(self.coalloc)
                             if x is c)
                    self.coalloc = self.coalloc[:i] + self.coalloc[i + 1:]
                    victims.append(c)
                else:
                    m = int(self._rng.choice(
                        len(self.alloc[h]), p=self.alloc[h] / serving))
                    self.alloc[h, m] -= 1
                    victims.append((h, m))
        self._force = True
        return victims

    # -- stepping ------------------------------------------------------------

    def _covers(self, target: np.ndarray) -> bool:
        served = (self.alloc * self.table.qps).sum(axis=0)
        for c in self.coalloc:
            for name, rate in zip(c.tenants, c.rates):
                served[self.table.workloads.index(name)] += rate
        return bool((served >= target - 1e-9).all())

    def _within_band(self, load: np.ndarray) -> bool:
        if self._provisioned_load is None:
            return False
        ref = np.maximum(self._provisioned_load, 1e-9)
        return bool((np.abs(load - self._provisioned_load) <=
                     self.transitions.hysteresis * ref).all())

    def _solve(self, load: np.ndarray) -> tuple[ProvisionResult, tuple]:
        table = EfficiencyTable(self.table.servers, self.table.workloads,
                                self.table.qps, self.table.power, self.avail)
        fn = POLICIES[self.policy]
        kwargs: dict = {"overprovision": self.overprovision}
        if self.policy == "nh":
            kwargs["seed"] = self.seed + self.t
        r = fn(table, load, **kwargs)
        if self.colocation is None or not r.feasible:
            return r, ()
        from repro_torch.core.colocation import pack_colocated
        packed = pack_colocated(table, self.colocation, load, r,
                                overprovision=self.overprovision)
        if packed.merges == 0:
            return r, ()
        return ProvisionResult(packed.alloc, packed.provisioned_power_w,
                               packed.capacity, True), packed.co_machines

    def step(self, load: np.ndarray, tail_ok: bool = True) -> StatefulStep:
        load = np.asarray(load, dtype=np.float64)
        target = load * (1.0 + self.overprovision)
        cfg = self.transitions
        hold = (not self._force) and tail_ok and self._within_band(load) and \
            self._covers(target)
        if hold:
            self.n_holds += 1
            alloc_new, co_new, feasible = self.alloc, self.coalloc, True
        else:
            boost = 1.0 if tail_ok else 1.0 + cfg.feedback_boost
            r, co_new = self._solve(load * boost)
            self.n_resolves += 1
            if not tail_ok:
                self.n_tail_resolves += 1
                if not r.feasible and boost > 1.0:
                    # the extra headroom is not available on this pool, but
                    # the offered load itself may still be provisionable —
                    # serve that rather than freezing on a stale allocation
                    r, co_new = self._solve(load)
            feasible = r.feasible
            if r.feasible:
                alloc_new = r.alloc
                self._provisioned_load = load.copy()
            else:
                # best effort: keep serving on whatever survives
                alloc_new, co_new = self.alloc, self.coalloc
                if not tail_ok and self._covers(target):
                    # only the boosted target overshot the pool; the real
                    # one is still covered, so the day itself is not lost
                    feasible = True
            self._force = False
        added = np.maximum(alloc_new - self.alloc, 0)
        removed = np.maximum(self.alloc - alloc_new, 0)
        co_added, co_removed = _co_diff(co_new, self.coalloc)
        if self._warm:  # day starts with a warm fleet: no load transient
            added = np.zeros_like(added)
            co_added = ()
            self._warm = False
        drain_frac = min(cfg.drain_s / cfg.interval_s, 1.0)
        power = float((alloc_new * self.table.power).sum())
        power += sum(c.power_w for c in co_new)
        power += float((removed * self.table.power).sum()) * drain_frac
        power += sum(c.power_w for c in co_removed) * drain_frac
        self.alloc = alloc_new
        self.coalloc = co_new
        self.t += 1
        return StatefulStep(
            alloc=alloc_new.copy(), power_w=power,
            capacity=int(alloc_new.sum()) + len(co_new),
            feasible=feasible, resolved=not hold, added=added, removed=removed,
            coalloc=co_new, co_added=co_added, co_removed=co_removed,
        )


def provision_day(
    table: EfficiencyTable,
    traces: np.ndarray,            # [M, T] per-workload diurnal loads
    policy: str = "hercules",
    overprovision: float = 0.05,
    seed: int = 0,
) -> dict:
    """Run a policy across the day; returns power/capacity time series."""
    M, T = traces.shape
    fn = POLICIES[policy]
    power = np.zeros(T)
    capacity = np.zeros(T, np.int64)
    allocs = []
    feasible = True
    for t in range(T):
        kwargs = {"overprovision": overprovision}
        if policy == "nh":
            kwargs["seed"] = seed + t
        r = fn(table, traces[:, t], **kwargs)
        feasible &= r.feasible
        power[t] = r.provisioned_power_w
        capacity[t] = r.capacity
        allocs.append(r.alloc)
    return {
        "power_w": power,
        "capacity": capacity,
        "allocs": np.stack(allocs),
        "feasible": feasible,
        "peak_power_w": float(power.max()),
        "avg_power_w": float(power.mean()),
        "peak_capacity": int(capacity.max()),
        "avg_capacity": float(capacity.mean()),
    }
