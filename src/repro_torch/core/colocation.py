"""Interference-aware multi-tenant packing (Hera direction).

Every machine in the base provisioner serves one workload.  This module
lets the offline stage pack *pairs* of complementary tenants onto shared
servers:

- :func:`build_colocation_table` profiles every admissible
  (server, tenant-set) cell — each tenant's solo record dilated by the
  co-resident tenant's measured pressure
  (:func:`repro_torch.core.perfmodel.colocation_dilation`) — with SLA-aware
  admission per tenant: a tenant whose *inflated* p95 would breach its SLA
  is rejected from that packing, and accelerator hosts are bounded by
  their ``AccelSpec.max_colocate`` slots.

- :func:`pack_colocated` improves a single-tenant ``ProvisionResult`` by a
  deterministic greedy merge pass: remove one machine from (h1, m1) and
  one from (h2, m2), add one shared machine of type h serving both
  residual contributions.  A merge is feasible when the shared machine's
  fractional utilization ``need1/qps_c1 + need2/qps_c2 <= 1`` (dilated
  rates) and the pool has a free machine of type h; it is applied only
  when it strictly reduces provisioned power, best-saving first with
  deterministic tie-breaks.  With an empty
  :class:`ColocationTable` the pass is the identity — single-tenant
  packings reproduce the base allocation bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cluster import EfficiencyTable, ProvisionResult
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.efficiency import (TABLE_QPS_TOL, default_query_sizes,
                                   profile_colocated)
from repro_torch.core.workload import ModelProfile

# Shared-machine utilization budget for the merge pass: the two tenants'
# fractional loads (at their dilated full-machine rates) may fill at most
# this much of the machine, keeping online tails clear of the SLA edge.
COLOC_PACK_UTIL = 0.85


@dataclasses.dataclass(frozen=True)
class ColoCell:
    """One admissible (server, tenant-set) packing: per-tenant dilated
    full-machine throughput/tail, aligned with ``tenants`` order."""

    server: str
    tenants: tuple[str, ...]       # sorted workload names
    qps: tuple[float, ...]         # dilated full-machine QPS per tenant
    p95_ms: tuple[float, ...]      # dilated tail per tenant
    dilation: tuple[float, ...]
    power_w: float                 # provisioned power (device peak)


@dataclasses.dataclass(frozen=True)
class CoMachine:
    """One shared machine in a packing: per-tenant assigned rates."""

    server: str
    tenants: tuple[str, ...]       # sorted workload names
    rates: tuple[float, ...]       # per-tenant QPS assigned to this machine
    qps: tuple[float, ...]         # per-tenant dilated full-machine QPS
    dilation: tuple[float, ...]    # per-tenant duration inflation (>= 1)
    power_w: float

    def rate_of(self, workload: str) -> float:
        return self.rates[self.tenants.index(workload)]

    def qps_of(self, workload: str) -> float:
        return self.qps[self.tenants.index(workload)]

    def dilation_of(self, workload: str) -> float:
        return self.dilation[self.tenants.index(workload)]


@dataclasses.dataclass(frozen=True)
class ColocationTable:
    """Admissible packings plus the SLA/slot rejections (for reporting)."""

    cells: tuple[ColoCell, ...]
    rejected: tuple[tuple[str, tuple[str, ...], str], ...] = ()

    def cell(self, server: str, tenants: tuple[str, ...]) -> ColoCell | None:
        key = tuple(sorted(tenants))
        for c in self.cells:
            if c.server == server and c.tenants == key:
                return c
        return None


def build_colocation_table(
    profiles: dict[str, ModelProfile],
    servers: dict[str, DeviceProfile],
    query_sizes: np.ndarray | None = None,
    seed: int = 0,
    engine: str = "fast",
    use_cache: bool = True,
    qps_tol: float = TABLE_QPS_TOL,
) -> ColocationTable:
    """Profile every (server, unordered tenant pair) cell with SLA-aware
    admission.  CPU hosts contend on shared memory bandwidth; accelerator
    hosts additionally require a free co-location slot
    (``AccelSpec.max_colocate``)."""
    qs = query_sizes if query_sizes is not None else default_query_sizes()
    names = sorted(profiles)
    cells: list[ColoCell] = []
    rejected: list[tuple[str, tuple[str, ...], str]] = []
    for sname in sorted(servers):
        dev = servers[sname]
        for i, n1 in enumerate(names):
            for n2 in names[i + 1:]:
                tenants = (n1, n2)
                if dev.accel is not None and len(tenants) > dev.accel.max_colocate:
                    rejected.append((sname, tenants, "no co-location slot"))
                    continue
                pairs = []
                breach = None
                for victim, other in ((n1, n2), (n2, n1)):
                    p = profile_colocated(
                        profiles[victim], dev, (profiles[other],), qs,
                        seed=seed, engine=engine, use_cache=use_cache,
                        qps_tol=qps_tol)
                    if p.qps <= 0.0 or p.p95_ms > profiles[victim].sla_ms:
                        breach = (f"{victim}: dilated p95 {p.p95_ms:.2f}ms > "
                                  f"SLA {profiles[victim].sla_ms:.0f}ms")
                        break
                    pairs.append(p)
                if breach is not None:
                    rejected.append((sname, tenants, breach))
                    continue
                cells.append(ColoCell(
                    server=sname, tenants=tenants,
                    qps=tuple(p.qps for p in pairs),
                    p95_ms=tuple(p.p95_ms for p in pairs),
                    dilation=tuple(p.dilation for p in pairs),
                    power_w=dev.peak_power_w,
                ))
    return ColocationTable(cells=tuple(cells), rejected=tuple(rejected))


@dataclasses.dataclass
class ColoProvision:
    """A packing: solo allocation plus shared machines."""

    alloc: np.ndarray                 # [H, M] solo machines (post-merge)
    co_machines: tuple[CoMachine, ...]
    provisioned_power_w: float
    capacity: int                     # activated machines incl. shared ones
    feasible: bool
    merges: int                       # merge moves applied


def co_served(co_machines: tuple[CoMachine, ...],
              workloads: tuple[str, ...]) -> np.ndarray:
    """Per-workload QPS ([M]) carried by the shared machines."""
    out = np.zeros(len(workloads))
    for c in co_machines:
        for name, rate in zip(c.tenants, c.rates):
            out[workloads.index(name)] += rate
    return out


def pack_colocated(
    table: EfficiencyTable,
    coloc: ColocationTable,
    load: np.ndarray,
    base: ProvisionResult,
    overprovision: float = 0.0,
) -> ColoProvision:
    """Greedy merge-improvement of `base` using the admissible packings.

    Deterministic: candidate moves are enumerated in index order and the
    best saving wins with ``(h, h1, h2, m1, m2)`` ascending tie-breaks.
    Returns the base allocation unchanged (``merges == 0``) when no merge
    is feasible or `coloc` has no cells.
    """
    H, M = table.qps.shape
    if not base.feasible:
        return ColoProvision(base.alloc.copy(), (), base.provisioned_power_w,
                             base.capacity, False, 0)
    target = np.asarray(load, np.float64) * (1.0 + overprovision)
    alloc = base.alloc.astype(np.int64).copy()
    machines: list[CoMachine] = []
    names = table.workloads

    def used_of(h: int) -> int:
        return int(alloc[h].sum()) + sum(
            1 for c in machines if c.server == table.servers[h])

    merges = 0
    while coloc.cells:
        served = (alloc * table.qps).sum(axis=0) + co_served(tuple(machines),
                                                             names)
        slack = served - target
        best = None  # (saving, -h, -h1, -h2, -m1, -m2, move) — max() picks it
        for m1 in range(M):
            for m2 in range(m1 + 1, M):
                key = tuple(sorted((names[m1], names[m2])))
                for h1 in range(H):
                    if alloc[h1, m1] <= 0:
                        continue
                    need1 = max(table.qps[h1, m1] - slack[m1], 0.0)
                    for h2 in range(H):
                        if alloc[h2, m2] <= 0:
                            continue
                        need2 = max(table.qps[h2, m2] - slack[m2], 0.0)
                        for h in range(H):
                            cell = coloc.cell(table.servers[h], key)
                            if cell is None:
                                continue
                            qc1 = cell.qps[cell.tenants.index(names[m1])]
                            qc2 = cell.qps[cell.tenants.index(names[m2])]
                            if qc1 <= 0.0 or qc2 <= 0.0:
                                continue
                            if need1 / qc1 + need2 / qc2 > \
                                    COLOC_PACK_UTIL + 1e-9:
                                continue
                            free = int(table.avail[h]) - used_of(h) \
                                + (h == h1) + (h == h2)
                            if free < 1:
                                continue
                            saving = float(table.power[h1, m1]
                                           + table.power[h2, m2]
                                           - cell.power_w)
                            if saving <= 1e-9:
                                continue
                            cand = (saving, -h, -h1, -h2, -m1, -m2,
                                    (h, h1, h2, m1, m2, need1, need2, cell))
                            if best is None or cand[:6] > best[:6]:
                                best = cand
        if best is None:
            break
        h, h1, h2, m1, m2, need1, need2, cell = best[6]
        alloc[h1, m1] -= 1
        alloc[h2, m2] -= 1
        rates = {names[m1]: need1, names[m2]: need2}
        machines.append(CoMachine(
            server=table.servers[h], tenants=cell.tenants,
            rates=tuple(rates[t] for t in cell.tenants),
            qps=cell.qps, dilation=cell.dilation, power_w=cell.power_w))
        merges += 1
    power = float((alloc * table.power).sum()) + sum(c.power_w
                                                     for c in machines)
    capacity = int(alloc.sum()) + len(machines)
    return ColoProvision(alloc, tuple(machines), power, capacity, True,
                         merges)
