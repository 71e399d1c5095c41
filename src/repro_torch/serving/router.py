"""Cluster-level query routing with failure handling + straggler hedging.

Completes the online-serving half of the paper with the mechanisms a real
fleet needs (fault tolerance):

- weighted routing across the servers a workload is allocated to (weights =
  each server's profiled QPS), via deterministic low-discrepancy assignment
  (:meth:`QueryRouter.assign_stream` — the golden-ratio sequence over the
  cumulative weight profile, segment-vectorized between pool changes);
- health tracking: a failed server's queries re-route and the cluster
  manager is told to re-provision (elastic N_h) — the cluster runtime calls
  the provisioner again with the reduced availability;
- transition awareness: a slot only takes new queries inside its
  ``[ready_at, retire_at)`` window — newly provisioned servers join the
  pool once their model load completes, drained servers leave it while
  still finishing in-flight work (`repro_torch.serving.cluster_runtime`);
- straggler mitigation: hedged re-dispatch — if a sub-query's latency
  exceeds the p99-based hedge threshold, a duplicate fires to the
  next-fastest server and the first completion wins (classic tail-at-scale
  hedging).  :meth:`QueryRouter.hedge_assign` picks the duplicate's target
  per straggler — the fastest slot, *other than the primary*, that accepts
  queries at the hedge's issue time; the cluster runtime then admits the
  duplicate into that slot's **live** queue (it contends with the slot's
  in-flight work, not its unloaded service time).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_GOLDEN = 0.6180339887498949  # frac(phi): lowest-discrepancy 1-D sequence


def split_stream_by_share(n: int, shares: np.ndarray,
                          seq: int = 0) -> np.ndarray:
    """Partition stream positions ``0..n-1`` among ``len(shares)`` groups.

    Group counts are the largest-remainder apportionment of ``n`` by
    ``shares`` (exact: counts sum to ``n``, every position lands in exactly
    one group); positions are interleaved by the same golden-ratio sequence
    ``assign_stream`` uses, so each group receives an evenly spread — not
    contiguous — slice of the stream.  Deterministic in ``(n, shares,
    seq)``.  The geo layer uses this to attribute a merged post-spill
    stream back to its origin regions (``repro_torch.serving.geo``).
    """
    shares = np.asarray(shares, dtype=np.float64)
    if shares.ndim != 1 or len(shares) == 0:
        raise ValueError("shares must be a non-empty 1-D array")
    if (shares < 0).any() or shares.sum() <= 0:
        raise ValueError("shares must be non-negative with a positive sum")
    out = np.empty(n, np.int64)
    if n == 0:
        return out
    quota = n * shares / shares.sum()
    counts = np.floor(quota).astype(np.int64)
    rem = n - int(counts.sum())
    if rem:  # largest fractional parts win; ties break to the lowest index
        frac = quota - counts
        order = np.lexsort((np.arange(len(shares)), -frac))
        counts[order[:rem]] += 1
    u = ((seq + np.arange(n)) * _GOLDEN) % 1.0
    pos = np.argsort(u, kind="stable")
    out[pos] = np.repeat(np.arange(len(shares), dtype=np.int64), counts)
    return out


@dataclasses.dataclass
class ServerSlot:
    server_type: str
    qps: float
    healthy: bool = True
    inflight: int = 0
    ready_at: float = 0.0          # model load completes (serving starts)
    retire_at: float = float("inf")  # drain deadline (stops taking queries)
    # physical machine identity.  None = a machine this tenant owns alone;
    # a shared (co-located) machine appears as one slot per tenant pool,
    # all carrying the same identity prefix, so a hardware failure can be
    # attributed to every tenant it serves (``mark_machine_failed``).
    machine: tuple | None = None

    def accepts(self, t: float) -> bool:
        return self.healthy and self.ready_at <= t < self.retire_at


class QueryRouter:
    def __init__(self, slots: list[ServerSlot], hedge_quantile: float = 0.99,
                 hedge_factor: float = 2.0, seed: int = 0):
        self.slots = slots
        self.hedge_quantile = hedge_quantile
        self.hedge_factor = hedge_factor
        self.rng = np.random.default_rng(seed)
        self._lat_samples: list[float] = []
        # low-discrepancy phase: seed-derived without consuming self.rng
        # (dispatch()'s failure draws stay bit-stable across this addition)
        self._seq = (int(seed) * 2654435761) % (1 << 16)

    # -- routing -------------------------------------------------------------

    def refresh(self, slots: list[ServerSlot]):
        """Swap in a new interval's slot pool, keeping latency history (the
        hedge threshold carries over) and the assignment sequence."""
        self.slots = slots

    def healthy_slots(self) -> list[ServerSlot]:
        return [s for s in self.slots if s.healthy]

    def pick(self) -> ServerSlot:
        """Weighted-least-loaded: weight by qps, penalize inflight depth."""
        live = self.healthy_slots()
        if not live:
            raise RuntimeError("no healthy servers for workload")
        score = [s.qps / (1.0 + s.inflight) for s in live]
        return live[int(np.argmax(score))]

    def mark_failed(self, slot: ServerSlot):
        slot.healthy = False

    def mark_machine_failed(self, machine: tuple) -> list[ServerSlot]:
        """Fail every slot whose identity starts with ``machine`` — the
        per-tenant views of one shared physical machine go down together.
        Returns the slots marked (for the caller's re-dispatch pass)."""
        hit = [s for s in self.slots if s.machine is not None
               and s.machine[:len(machine)] == machine]
        for s in hit:
            s.healthy = False
        return hit

    def sla_attribution(self, assigned: np.ndarray, latency: np.ndarray,
                        sla_s: float) -> dict[tuple | None, dict]:
        """Per-machine SLA attribution of one served stream: for every
        machine identity in the pool (``None`` groups all tenant-exclusive
        slots), the queries it served and how many met ``sla_s``.  Lets a
        co-located day answer "which shared machine hurt which tenant"
        without re-simulating."""
        assigned = np.asarray(assigned, np.int64)
        latency = np.asarray(latency, np.float64)
        out: dict[tuple | None, dict] = {}
        for i, s in enumerate(self.slots):
            sel = latency[assigned == i]
            if len(sel) == 0:
                continue
            g = out.setdefault(s.machine, {"n_queries": 0, "n_met": 0})
            g["n_queries"] += int(len(sel))
            g["n_met"] += int((sel <= sla_s).sum())
        return out

    def assign_stream(self, arrivals: np.ndarray) -> np.ndarray:
        """Assign each arrival to a slot; returns slot indices.

        Deterministic low-discrepancy weighted assignment: query ``i`` maps
        to the slot whose cumulative-weight bin contains ``frac(i * phi)``
        (weights = profiled QPS), so every weight-``w`` slot receives a
        ``w``-proportional, evenly interleaved share of the stream without
        per-query randomness — reproducible across policies (CRN) and free
        of the clumping a multinomial draw would add.  The pool is
        re-evaluated at slot readiness/retirement boundaries inside the
        stream (segment-vectorized); raises ``RuntimeError`` when no slot
        accepts queries at some point of the stream.
        """
        arrivals = np.asarray(arrivals, dtype=np.float64)
        n = len(arrivals)
        out = np.empty(n, np.int64)
        if n == 0:
            return out
        # pool-change boundaries that fall inside this stream
        edges = {s.ready_at for s in self.slots} | {s.retire_at for s in self.slots}
        cuts = sorted(e for e in edges if arrivals[0] < e <= arrivals[-1])
        bounds = [0] + [int(np.searchsorted(arrivals, c, side="left"))
                        for c in cuts] + [n]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if lo >= hi:
                continue
            t = float(arrivals[lo])
            w = np.array([s.qps if s.accepts(t) else 0.0 for s in self.slots])
            total = w.sum()
            if total <= 0.0:
                raise RuntimeError("no healthy servers for workload")
            cum = np.cumsum(w) / total
            u = ((self._seq + np.arange(lo, hi)) * _GOLDEN) % 1.0
            out[lo:hi] = np.minimum(np.searchsorted(cum, u, side="right"),
                                    len(self.slots) - 1)
        self._seq += n
        return out

    # -- hedging -------------------------------------------------------------

    def hedge_assign(self, primary: np.ndarray,
                     t_issue: np.ndarray) -> np.ndarray:
        """Hedge target per straggler: the highest-QPS slot other than the
        straggler's ``primary`` slot that accepts queries at the hedge's
        issue time (``-1`` when no such slot exists — loading, draining and
        failed slots can't take a duplicate).  The caller admits the
        duplicate into the target's live queue at ``t_issue``."""
        primary = np.asarray(primary, np.int64)
        t_issue = np.asarray(t_issue, np.float64)
        out = np.full(len(primary), -1, np.int64)
        for j, (p, ti) in enumerate(zip(primary.tolist(), t_issue.tolist())):
            best, best_qps = -1, -1.0
            for i, s in enumerate(self.slots):
                if i != p and s.qps > best_qps and s.accepts(ti):
                    best, best_qps = i, s.qps
            out[j] = best
        return out

    def hedge_events(self, assigned: np.ndarray, arrivals: np.ndarray,
                     latency: np.ndarray, threshold: float,
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Straggler detection + duplicate targeting as one event extraction.

        Returns ``(straggler, t_issue, alt)``: indices of finite-latency
        queries over ``threshold``, the duplicates' issue times
        (``arrival + threshold`` — the moment the client gives up waiting),
        and each duplicate's target slot from :meth:`hedge_assign`
        (``-1`` = no slot accepts at issue time).  This is the runtime's
        historical straggler selection consolidated behind the router, so
        both the first-pass and the event-ordered hedging passes emit the
        identical event stream."""
        straggler = np.flatnonzero(np.isfinite(latency)
                                   & (latency > threshold))
        t_issue = np.asarray(arrivals, np.float64)[straggler] + threshold
        if len(straggler) == 0:
            return straggler, t_issue, np.zeros(0, np.int64)
        alt = self.hedge_assign(np.asarray(assigned, np.int64)[straggler],
                                t_issue)
        return straggler, t_issue, alt

    def hedge_threshold(self) -> float:
        if len(self._lat_samples) < 32:
            return float("inf")
        return self.hedge_factor * float(
            np.quantile(self._lat_samples, self.hedge_quantile)
        )

    def observe_latency(self, seconds: float):
        self._lat_samples.append(seconds)
        if len(self._lat_samples) > 4096:
            self._lat_samples = self._lat_samples[-2048:]

    def observe_many(self, seconds: np.ndarray):
        self._lat_samples.extend(np.asarray(seconds, dtype=float).tolist())
        if len(self._lat_samples) > 4096:
            self._lat_samples = self._lat_samples[-2048:]

    def dispatch(self, service_time_fn, fail_prob: float = 0.0) -> tuple[float, int]:
        """Simulate one query: returns (latency, n_attempts).

        service_time_fn(slot) -> seconds (caller supplies per-server model);
        with probability fail_prob a chosen server dies mid-query (tests the
        failure path)."""
        attempts = 0
        best = float("inf")
        threshold = self.hedge_threshold()
        tried: list[ServerSlot] = []
        while attempts < 3:
            slot = self.pick()
            attempts += 1
            tried.append(slot)
            slot.inflight += 1
            if fail_prob > 0 and self.rng.random() < fail_prob:
                self.mark_failed(slot)
                slot.inflight -= 1
                continue  # re-route to a healthy server
            t = service_time_fn(slot)
            slot.inflight -= 1
            best = min(best, t)
            if t <= threshold:
                break
            # straggler: hedge once to the next-best server
            threshold = float("inf") if attempts >= 2 else threshold
        self.observe_latency(best)
        return best, attempts
