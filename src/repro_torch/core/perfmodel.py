"""Analytic execution of an operator profile on a device profile.

This is the evaluation engine behind Hercules' offline profiling: it turns
(model profile, device profile, scheduling configuration) into stage service
times that the discrete-event serving simulator composes into latency-bounded
throughput, and into component utilizations for the power model.

CPU threads: ``o`` operator workers (one physical core each, paper §II-B);
elapsed time per dependency level is the list-scheduling bound
``max(longest op, level work / o)`` which reproduces the idle-cycle growth of
paper Fig. 5. Memory bandwidth is shared across co-located threads; NMP
DIMMs multiply *gather* bandwidth only (rank-parallel SLS offload).

Accelerators: a two-resource pipeline — host link (PCIe: input/ids/psum
transfer) and engine (kernels). Co-location overlaps one thread's link phase
with another's engine phase (this is where Baymax/query-fusion wins come
from, Fig. 6/7); batch efficiency saturates as eff(b) = b/(b + b_half).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Sequence

from repro_torch.core.devices import DeviceProfile
from repro_torch.core.workload import ModelProfile, OpCost

# Engine batch-efficiency half-point: batch at which an accelerator kernel
# reaches 50% of peak (GEMM-shaped ops).
B_HALF = 48.0
# Sequential (recurrent) ops cap achievable engine efficiency.
SEQ_EFF = 0.15
# Per-thread LLC/prefetcher interference on CPUs (paper Fig. 4 territory).
CPU_INTERFERENCE = 0.05
# Batch-split (intra-op data parallel) efficiency across operator workers.
WORKER_EFF = 0.85
# Per-core achievable bandwidth (limited outstanding misses): a thread of o
# workers cannot pull more than o x these, no matter its share of the bus.
CORE_STREAM_GBS = 14.0
CORE_GATHER_GBS = 4.0


@dataclasses.dataclass(frozen=True)
class CpuAlloc:
    threads: int          # m co-located inference threads
    workers: int          # o operator workers (cores) per thread

    @property
    def cores(self) -> int:
        return self.threads * self.workers


def cpu_stage_time(
    ops: Sequence[OpCost],
    batch: int,
    workers: int,
    device: DeviceProfile,
    active_threads: int,
    nmp_offload: bool = True,
) -> float:
    """Elapsed seconds for one thread to run `ops` on a `batch` of items.

    Compute scales with op-workers via list scheduling
    (max(longest op, level work / o)); memory traffic is bounded by the
    thread's *bandwidth share* regardless of workers — extra workers cannot
    mint bandwidth, which is what keeps total system throughput conserved
    across (m × o) splits for memory-bound models (paper Fig. 4's modest,
    not multiplicative, wins)."""
    cpu, mem = device.cpu, device.mem
    core_rate = cpu.gflops_per_core * 1e9
    interference = 1.0 + CPU_INTERFERENCE * max(active_threads - 1, 0)
    share = max(active_threads, 1)
    w = max(workers, 1)
    nmp = mem.nmp_factor if nmp_offload else 1.0
    stream_bw = min(
        mem.bw_gbs * 1e9 / share,
        CORE_STREAM_GBS * 1e9 * w,
    ) / interference
    gather_bw = min(
        mem.bw_gbs * 1e9 * mem.gather_eff / share,
        CORE_GATHER_GBS * 1e9 * w,
    ) * nmp / interference
    levels: dict[int, list[OpCost]] = defaultdict(list)
    for op in ops:
        levels[op.level].append(op)
    total = 0.0
    w = max(workers, 1)
    for lvl in sorted(levels):
        lops = levels[lvl]
        # Batched ops split the batch across workers (intra-op data
        # parallelism at WORKER_EFF); independent ops also spread across
        # workers — the binding term is total level work / effective cores.
        cts = [op.flops * batch / core_rate for op in lops]
        eff_w = 1.0 + (w - 1.0) * WORKER_EFF
        t_compute = max(max(cts) / eff_w, sum(cts) / (w * WORKER_EFF + (1 - WORKER_EFF)))
        t_mem = (
            sum(op.stream_bytes * batch + op.weight_bytes for op in lops) / stream_bw
            + sum(op.gather_bytes for op in lops) * batch / gather_bw
        )
        total += max(t_compute, t_mem)
    return total


def cpu_stage_core_seconds(
    ops: Sequence[OpCost], batch: int, device: DeviceProfile
) -> float:
    """Busy core-seconds (for utilization/power accounting)."""
    core_rate = device.cpu.gflops_per_core * 1e9
    return sum(op.flops * batch / core_rate for op in ops)


def accel_engine_time(
    ops: Sequence[OpCost], batch: int, device: DeviceProfile
) -> float:
    """Engine-resident seconds for one batched kernel sequence."""
    acc = device.accel
    assert acc is not None
    total = 0.0
    for op in ops:
        eff = batch / (batch + B_HALF)
        if op.sequential:
            eff = min(eff, SEQ_EFF)
        t_compute = op.flops * batch / (acc.peak_gflops * 1e9 * max(eff, 1e-3))
        t_stream = (op.stream_bytes * batch + op.weight_bytes) / (acc.hbm_gbs * 1e9)
        t_gather = op.gather_bytes * batch / (acc.hbm_gbs * 1e9 * acc.gather_eff)
        total += max(t_compute, t_stream, t_gather) + acc.kernel_overhead_us * 1e-6
    return total


def accel_link_time(host_bytes_per_item: float, batch: int, device: DeviceProfile) -> float:
    acc = device.accel
    assert acc is not None
    return host_bytes_per_item * batch / (acc.link_gbs * 1e9) + 10e-6  # DMA setup


# -- multi-tenant interference (Hera direction) ------------------------------
#
# Co-located tenants share the server's bottleneck resources: stream and
# gather memory bandwidth on CPU hosts, the engine and the host link on
# accelerator hosts.  The contention model is deliberately *measured at the
# solo operating point*: each tenant's pressure on a resource is the fraction
# of that resource its solo profile consumes at its solo peak QPS, and a
# victim's duration tables dilate by a queueing-shaped penalty
# ``1 + sens_r * alpha_r * u / (1 - u)`` summed over resources — exact 1.0
# for an empty co-set, monotone non-decreasing in every pressure component.

PRESSURE_RESOURCES = ("stream", "gather", "engine", "link")

# Per-resource contention coefficients (alpha_r): how strongly a unit of
# co-tenant utilization on the resource inflates a fully-sensitive victim.
COLOC_ALPHA = {
    "stream": 0.9,   # shared DDR stream bandwidth (CPU hosts)
    "gather": 0.7,   # random-gather bandwidth (SLS contention)
    "engine": 0.6,   # accel co-location slots (MPS-style time sharing)
    "link": 0.5,     # host<->device link (PCIe DMA contention)
}
# Cap on the aggregate co-tenant utilization entering the 1/(1-u) law — a
# saturated co-tenant dilates a lot, not infinitely.
COLOC_UTIL_CAP = 0.85


def _resource_seconds(profile: ModelProfile, device: DeviceProfile) -> dict:
    """Seconds per item each shared resource spends on `profile`'s totals."""
    t = profile.totals()
    mem = device.mem
    out = {
        "stream": t["stream_bytes"] / (mem.bw_gbs * 1e9),
        "gather": t["gather_bytes"] / (
            mem.bw_gbs * 1e9 * mem.gather_eff * mem.nmp_factor),
        "engine": 0.0,
        "link": 0.0,
    }
    acc = device.accel
    if acc is not None:
        out["engine"] = t["flops"] / (acc.peak_gflops * 1e9)
        out["link"] = t["host_bytes"] / (acc.link_gbs * 1e9)
    return out


def tenant_pressure(profile: ModelProfile, device: DeviceProfile,
                    qps: float, mean_query_items: float) -> dict:
    """Shared-resource utilization fractions a tenant exerts on `device`
    at an operating point of ``qps`` queries/s (``mean_query_items`` items
    per query, paper Fig. 2b sample mean).  Values are >= 0 and not capped
    here — :func:`colocation_dilation` applies ``COLOC_UTIL_CAP``."""
    items_s = max(qps, 0.0) * max(mean_query_items, 0.0)
    sec = _resource_seconds(profile, device)
    return {r: sec[r] * items_s for r in PRESSURE_RESOURCES}


def resource_sensitivity(profile: ModelProfile, device: DeviceProfile) -> dict:
    """Victim-side sensitivity shares: the fraction of `profile`'s
    resource-seconds bound to each shared resource on `device` (sparse
    models weight gather, dense models weight stream/engine).  Sums to 1
    for a non-empty profile."""
    sec = _resource_seconds(profile, device)
    total = sum(sec.values())
    if total <= 0.0:
        return {r: 0.0 for r in PRESSURE_RESOURCES}
    return {r: sec[r] / total for r in PRESSURE_RESOURCES}


def colocation_dilation(profile: ModelProfile, device: DeviceProfile,
                        co_pressures: Sequence[dict]) -> float:
    """Multiplicative duration dilation (>= 1.0) that the co-resident
    tenants' aggregate pressure imposes on `profile` when sharing `device`.

    Exactly 1.0 for an empty co-set (single-tenant packings reproduce the
    solo tables bitwise); monotone non-decreasing in every pressure
    component (adding a tenant never shortens durations)."""
    pressures = list(co_pressures)
    if not pressures:
        return 1.0
    sens = resource_sensitivity(profile, device)
    d = 1.0
    for r in PRESSURE_RESOURCES:
        u = sum(max(p.get(r, 0.0), 0.0) for p in pressures)
        u = min(u, COLOC_UTIL_CAP)
        if u > 0.0:
            d += COLOC_ALPHA[r] * sens[r] * u / (1.0 - u)
    return d


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Average power from component utilizations (paper: RAPL + nvidia-smi)."""

    device: DeviceProfile

    def average_power(self, util: dict) -> float:
        """util keys: cores (0-1), mem (0-1), engine (0-1), link (0-1)."""
        d = self.device
        p = d.cpu.idle_w + (d.cpu.tdp_w - d.cpu.idle_w) * util.get("cores", 0.0)
        p += d.mem.idle_w + (d.mem.tdp_w - d.mem.idle_w) * util.get("mem", 0.0)
        if d.accel:
            p += d.accel.idle_w + (d.accel.tdp_w - d.accel.idle_w) * util.get(
                "engine", 0.0
            )
        return p

    def provisioned_power(self) -> float:
        return self.device.peak_power_w


def memory_utilization(
    profile_bytes_per_s: float, device: DeviceProfile
) -> float:
    return min(profile_bytes_per_s / (device.mem.bw_gbs * 1e9), 1.0)
