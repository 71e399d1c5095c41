"""A Hercules cluster day on the port: a full day of heterogeneity-aware online serving —
stateful provisioning with hysteresis and transition delays, routed Poisson
query streams served continuously in time (per-slot backlog carries across
provisioning intervals, hedges ride live queues), and node failures
injected mid-day (elastic re-provisioning through the router's health
tracking plus achieved-tail feedback into the hysteresis decision).

The day itself is a declaration: the registered ``failure_day`` scenario
(see ``repro_torch.serving.scenarios`` and docs/scenarios.md) customized
with a harsher failure schedule, lifted to the full paper zoo by
``full_scale`` unless ``--smoke``.  Port of ``examples/cluster_day.py``.

Run:  PYTHONPATH=src python -m repro_torch.launch.cluster_day \
          [--smoke] [--event-core] [--device cuda|cpu]

``--smoke`` keeps the scenario's registered reduced topology (2 workloads
x 3 server types, short day) so CI can run the full pipeline in seconds.
``--event-core`` re-serves the same day through the batched event-ordered
core (``runtime={"event_core": True}``: whole intervals simulated query by
query, hedges admitted in global event order) and prints the exact p99
next to the bridged approximation's.  ``--device`` (default ``cuda``) is
where that day's fleet groups run: the fleet FIFO kernel (K4) on the card,
its plain PyTorch version on ``cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.kernels.fleet_fifo import ops as k4
from repro_torch.serving import event_core as ec
from repro_torch.serving.scenarios import (
    Event,
    compile_scenario,
    full_scale,
    get_scenario,
)


def main(smoke: bool = False, event_core: bool = False,
         device: str = "cuda"):
    # The registered failure day uses the benchmark's gentle 1% schedule;
    # this example stresses harder: 2% per server type per interval.
    day = dataclasses.replace(
        get_scenario("failure_day"),
        events=(Event.create("random_failures", fail_prob=0.02, seed=0),))
    if not smoke:
        day = full_scale(day, n_steps=96)
    n_steps = day.n_steps

    # Profiled (workload, server) cells persist under
    # artifacts/profiles_torch/; the first run searches every cell (fast
    # engine), reruns replay from disk (see docs/ARCHITECTURE.md "Offline
    # profiling").
    comp = compile_scenario(day, verbose=True)
    out = comp.run(device=device)  # a typed DayResult (attributes, not keys)

    print("\nt     power(kW)  servers  churn")
    for t in range(n_steps):
        if t % max(n_steps // 12, 1) == 0 or out.churn[t]:
            print(f"{t:3d}   {out.power[t]/1e3:8.1f}  "
                  f"{out.capacity[t]:7d}  {out.churn[t]:5d}")
    print("\nevents:")
    for e in out.events:
        print("  ", e)
    print(f"\nday feasible={out.feasible}  "
          f"peak_power={out.peak_power_w/1e3:.1f}kW  "
          f"resolves={out.resolves} holds={out.holds} "
          f"tail_resolves={out.tail_resolves} "
          f"churn={out.total_churn}")
    print(f"{'workload':<12} {'sla':>6} {'p99(ms)':>8} {'attain':>7} "
          f"{'intv_ok':>7} {'hedged':>6} {'retried':>7}")
    for w, d in out.per_workload.items():
        print(f"{w:<12} {d['sla_ms']:6.0f} {d['p99_ms']:8.2f} "
              f"{d['sla_attainment']:7.4f} {d['interval_sla_met_frac']:7.3f} "
              f"{d['n_hedged']:6d} {d['n_retried']:7d}")

    # SLA over the day (Fig. 8b view): worst interval per workload, and the
    # carried-backlog peak — where the continuous-time semantics bite
    print("\nSLA over the day (per-interval series):")
    for w, s in out.series["per_workload"].items():
        idx = [t for t, a in enumerate(s["sla_attainment"]) if a is not None]
        worst_t = min(idx, key=lambda t: s["sla_attainment"][t])
        print(f"  {w:<12} worst interval t={worst_t}: "
              f"attain={s['sla_attainment'][worst_t]:.4f} "
              f"p99={s['p99_ms'][worst_t]:.2f}ms  "
              f"peak_backlog={max(s['backlog_s']):.3f}s")
    assert out.feasible, "day must stay feasible through failures"

    if event_core:
        # Exact vs bridged: the same day with every interval simulated to
        # its boundary (up to the per-interval query cap) instead of a
        # 1500-query window bridged by stationarity.
        cap = 20_000 if smoke else 200_000
        ec.stats_reset()
        k4.launches = 0
        exact = compile_scenario(dataclasses.replace(
            day, runtime={"event_core": True,
                          "event_core_queries": cap})).run(device=device)
        assert exact.feasible
        print(f"\nevent core (exact, <= {cap} queries/interval) vs "
              "bridged windows:")
        print(f"{'workload':<12} {'queries':>10} {'(bridged)':>10} "
              f"{'p99 exact':>10} {'(bridged)':>10} {'delta':>8}")
        for w, d in exact.per_workload.items():
            b = out.per_workload[w]
            delta = d["p99_ms"] - b["p99_ms"]
            print(f"{w:<12} {d['n_queries']:>10d} {b['n_queries']:>10d} "
                  f"{d['p99_ms']:>10.2f} {b['p99_ms']:>10.2f} "
                  f"{delta:>+8.2f}")
        capped = {
            w: sum(s["bridged"])
            for w, s in exact.series["per_workload"].items()
            if any(s["bridged"])
        }
        print("  intervals still capped:", capped if capped else "none — "
              "every interval fully simulated")
        st = ec.stats
        print(f"  fleet: {st['fleet_calls']} calls, {st['fleet_jobs']} jobs, "
              f"{st['fleet_groups']} wide groups ({st['fleet_kernel']} "
              f"streams through K4 on {device}, {k4.launches} kernel "
              f"launches), {st['fleet_seq']} streams through the sweep")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced table + short day (CI)")
    ap.add_argument("--event-core", action="store_true",
                    help="also serve the day exactly (batched "
                         "event-ordered core) and print exact-vs-bridged "
                         "p99 deltas")
    ap.add_argument("--device", default="cuda",
                    help="where the event-core fleet runs: cuda (the K4 "
                         "kernel) or cpu (its plain version)")
    main(**vars(ap.parse_args()))
