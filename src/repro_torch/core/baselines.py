"""State-of-the-art baseline task schedulers (paper §III).

- DeepRecSys [ISCA'20]: CPU model-based scheduling with the full thread
  count (one core per inference thread) exploring only the batch dimension
  P(D); on accelerators, no model co-location and no query fusion.
- Baymax [ASPLOS'16]: accelerator model co-location (searches m) but no
  query fusion.

Both receive the same HW-aware partition Hercules uses (the paper runs all
Fig. 14 evaluations at production scale with the locality-aware partition),
so the deltas isolate the *scheduling-space* contribution.

Each sweep shares one :class:`~repro_torch.serving.simulator.SimCache` across all
its grid points (common random numbers + shared duration tables), and can
persist its result through :mod:`repro_torch.core.profile_cache` so benchmarks
and cluster provisioning stop re-running identical baseline scans.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import profile_cache
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.gradient_search import BATCH_GRID
from repro_torch.core.partition import enumerate_placements
from repro_torch.core.workload import ModelProfile
from repro_torch.serving.simulator import SchedConfig, SimCache, max_sustainable_qps

BAYMAX_BATCH_CAPS = (256, 1024)  # batch cap only bounds the split granularity


def _best_accel_placement(profile, device):
    pls = enumerate_placements(profile, device)
    for plan in ("accel_full", "accel_hot", "accel_sd"):
        for p in pls:
            if p.plan == plan:
                return p
    return None


def _placement_by_plan(profile, device, plan):
    for p in enumerate_placements(profile, device):
        if p.plan == plan:
            return p
    return None


def _cached(kind, profile, device, query_sizes, seed, grid):
    key = profile_cache.pair_key(kind, profile, device, query_sizes,
                                 seed=seed, batch_grid=grid)
    rec = profile_cache.load(kind, profile.name, device.name, key)
    if rec is None:
        return key, None
    sched = SchedConfig(**rec["sched"]) if rec["sched"] else None
    pl = _placement_by_plan(profile, device, rec["plan"]) if rec["plan"] else None
    return key, (rec["qps"], sched, pl)


def _store(kind, profile, device, key, best):
    qps, sched, pl = best
    profile_cache.store(kind, profile.name, device.name, key, {
        "qps": qps,
        "sched": dataclasses.asdict(sched) if sched else None,
        "plan": pl.plan if pl else None,
    })


def deeprecsys_qps(profile: ModelProfile, device: DeviceProfile,
                   query_sizes: np.ndarray, seed: int = 0,
                   engine: str = "fast", use_cache: bool = False):
    """DeepRecSys: CPU -> fixed cores x 1 threads, P(D) sweep;
    accel -> single thread, no fusion, P(D) sweep."""
    if use_cache:
        key, hit = _cached("deeprecsys", profile, device, query_sizes, seed,
                           BATCH_GRID)
        if hit is not None:
            return hit
    cache = SimCache(query_sizes, seed)
    best = (0.0, None, None)
    if device.has_accel:
        pl = _best_accel_placement(profile, device)
        if pl is not None:
            for d in BATCH_GRID:
                sched = SchedConfig(batch=d, m=1, o=1, fuse=False)
                qps, res = max_sustainable_qps(pl, device, sched,
                                               profile.sla_ms, query_sizes,
                                               seed=seed, cache=cache,
                                               engine=engine)
                if qps > best[0]:
                    best = (qps, sched, pl)
    else:
        pl = enumerate_placements(profile, device)[0]  # cpu_model
        m = device.cpu.cores
        for d in BATCH_GRID:
            sched = SchedConfig(batch=d, m=m, o=1)
            qps, res = max_sustainable_qps(pl, device, sched, profile.sla_ms,
                                           query_sizes, seed=seed, cache=cache,
                                           engine=engine)
            if qps > best[0]:
                best = (qps, sched, pl)
    if use_cache:
        _store("deeprecsys", profile, device, key, best)
    return best


def baymax_qps(profile: ModelProfile, device: DeviceProfile,
               query_sizes: np.ndarray, seed: int = 0,
               engine: str = "fast", use_cache: bool = False):
    """Baymax: accelerator co-location (sweep m), no query fusion."""
    if not device.has_accel:
        return deeprecsys_qps(profile, device, query_sizes, seed,
                              engine=engine, use_cache=use_cache)
    pl = _best_accel_placement(profile, device)
    if pl is None:
        return deeprecsys_qps(profile, device, query_sizes, seed,
                              engine=engine, use_cache=use_cache)
    if use_cache:
        key, hit = _cached("baymax", profile, device, query_sizes, seed,
                           BAYMAX_BATCH_CAPS)
        if hit is not None:
            return hit
    cache = SimCache(query_sizes, seed)
    best = (0.0, None, None)
    for m in range(1, device.accel.max_colocate + 1):
        for d in BAYMAX_BATCH_CAPS:
            sched = SchedConfig(batch=d, m=m, o=1, fuse=False)
            qps, res = max_sustainable_qps(pl, device, sched, profile.sla_ms,
                                           query_sizes, seed=seed, cache=cache,
                                           engine=engine)
            if qps > best[0]:
                best = (qps, sched, pl)
    if use_cache:
        _store("baymax", profile, device, key, best)
    return best
