"""Online serving of a DLRM behind its Hercules schedule, on the GPU.

Port of ``examples/serve_recsys.py`` with one difference: the executed
model is the scheduled model at its production width (by default
``dlrm-rmc1``: 10 tables x 2.5 M rows x 32, 3.2 GB of f32 tables on the
card), not a small stand-in.  As in the reference:

- the offline stage picks the schedule with ``gradient_search`` over 300
  query sizes (``o_grid=(1, 2)``) for the chosen server type;
- a one-slot ``QueryRouter`` stands in front and observes every latency;
- queries arrive with Poisson gaps, and each is served as fused launches
  of ``d`` items (the schedule's batch), every launch padded to ``d``.

A query's features are generated before its clock starts (they arrive
with the request), so a latency is: features to the device, the model
(SparseNet through kernel K1, DenseNet), scores back to the host.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_recsys \\
          [--model dlrm-rmc1] [--server T2] [--seconds 5] [--qps 60]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.common.types import resolve_device
from repro_torch.configs.paper_models import PAPER_MODELS, paper_profile
from repro_torch.core.devices import SERVER_TYPES
from repro_torch.core.gradient_search import gradient_search
from repro_torch.core.workload import ModelProfile
from repro_torch.data.clicklog import ClickLogGenerator
from repro_torch.kernels.embedding_bag import ops as k1
from repro_torch.models import dlrm
from repro_torch.models.recsys_base import RecsysConfig, batch_to_tensors
from repro_torch.serving.router import QueryRouter, ServerSlot

SERVABLE = ("dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3")


def serve(cfg: RecsysConfig, profile: ModelProfile, server: str = "T2", *,
          device: str | torch.device = "cuda", n_queries: int | None = None,
          seconds: float | None = None, qps: float = 60.0, seed: int = 0,
          model: dlrm.DLRM | None = None, keep_launches: int = 0) -> dict:
    """Serve ``cfg`` behind the schedule computed for ``profile`` on
    ``server``, for ``n_queries`` queries or ``seconds`` of wall time.

    ``model`` defaults to a DLRM with random weights made on ``device``
    from ``seed``.  The first ``keep_launches`` fused launches are
    returned as ``(numpy batch, numpy scores)`` pairs under ``"kept"``.

    Returns latencies (ms), served queries and items, the schedule, the
    number of fused launches and the K1 launches counted during the call.
    """
    if (n_queries is None) == (seconds is None):
        raise ValueError("give exactly one of n_queries and seconds")
    if (n_queries or seconds) <= 0:
        raise ValueError("n_queries and seconds must be positive")
    dev = resolve_device(device)
    gen = ClickLogGenerator(cfg, seed=seed + 1)

    # offline stage: the schedule for this workload on this server type
    res = gradient_search(profile, SERVER_TYPES[server], gen.query_sizes(300),
                          o_grid=(1, 2))
    d = res.sched.batch
    schedule = {"plan": res.placement.plan, "batch": d, "m": res.sched.m,
                "o": res.sched.o, "qps": res.qps, "p95_ms": res.p95_ms}
    router = QueryRouter([ServerSlot(server, res.qps)])

    if model is None:
        model = dlrm.init(cfg, generator=torch.Generator(dev).manual_seed(seed),
                          device=dev)

    def launch(batch_np: dict) -> torch.Tensor:
        scores = model(batch_to_tensors(batch_np, dev))
        return scores.float().cpu()  # the scores reach the host: launch done

    k1_start = k1.launches
    rng = np.random.default_rng(seed)
    lat, kept = [], []
    served = items = fused = 0
    with torch.inference_mode():
        launch(gen.batch(d, with_labels=False))  # warm-up, not timed
        t_start = time.perf_counter()
        while (served < n_queries if n_queries is not None
               else time.perf_counter() - t_start < seconds):
            q = int(gen.query_sizes(1)[0])
            batches = [gen.batch(d, with_labels=False)  # padded fused launches
                       for _ in range(0, q, d)]
            t0 = time.perf_counter()
            scores = [launch(b) for b in batches]
            dt = time.perf_counter() - t0
            router.observe_latency(dt)
            lat.append(dt)
            for b, s in zip(batches, scores):
                if len(kept) < keep_launches:
                    kept.append((b, s.numpy()))
            served += 1
            items += q
            fused += len(batches)
            gap = rng.exponential(1.0 / qps)
            time.sleep(max(0.0, gap - dt))
        wall = time.perf_counter() - t_start
    lat_ms = np.asarray(lat) * 1e3
    return {
        "model": cfg.name,
        "server": server,
        "device": str(dev),
        "schedule": schedule,
        "served_queries": served,
        "items": items,
        "fused_launches": fused,
        "warmup_launches": 1,
        "k1_launches": k1.launches - k1_start,
        "wall_s": wall,
        "latency_ms": lat_ms.tolist(),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "kept": kept,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="dlrm-rmc1", choices=SERVABLE)
    ap.add_argument("--server", default="T2", choices=sorted(SERVER_TYPES))
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--qps", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = PAPER_MODELS[args.model](True)
    out = serve(cfg, paper_profile(args.model), args.server,
                device=args.device, seconds=args.seconds, qps=args.qps,
                seed=args.seed)
    s = out["schedule"]
    print(f"hercules schedule: plan={s['plan']} d={s['batch']} m={s['m']} "
          f"o={s['o']}")
    print(f"served {out['served_queries']} queries ({out['items']} items) in "
          f"{out['wall_s']:.1f}s on {out['device']}")
    print(f"latency p50={out['p50_ms']:.2f}ms p95={out['p95_ms']:.2f}ms "
          f"p99={out['p99_ms']:.2f}ms")
    out.pop("kept")
    out.pop("latency_ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
