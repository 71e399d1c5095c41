#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - the card (nvidia-smi name and power limit), TF32 switched off;
  2. build   - nvcc builds every CUDA source of the port for sm_90a;
  3. kernel  - kernel K1 (hot embedding bag) against its plain PyTorch
               version on the card: the dlrm-rmc1 production launch shape
               (f32), a dlrm-rm2 FULL-shaped bf16 table past 2**31
               elements, a batch of 37 bags and all-padding bags; timed with
               CUDA events beside the plain version, torch's embedding_bag
               and the card's bandwidth bound;
  4. serve   - the main path: dlrm-rmc1 at production width served behind
               its Hercules schedule (``repro_torch.launch.serve_recsys``),
               with K1's launch count checked against the fused launches and
               one fused batch's logits checked against the plain path.
Then the kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits 2 before any phase.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SERVE_QUERIES = 40
SERVE_QPS = 60.0
TIMING_REPS = 25
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers host enqueue
F32_TOL = 1e-5    # tests/test_kernels.py tolerances
BF16_TOL = 3e-2
LOGIT_TOL = 1e-4  # fp32 sums in another order inside the MLPs

# Data-sheet HBM bandwidth (bytes/s) and non-tensor f32 rate (FLOP/s) by the
# name nvidia-smi gives; NVIDIA H100 data sheet, dense rates.
CARDS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),   # SXM5
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 60e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float, str]:
    if name in CARDS:
        bw, f32 = CARDS[name]
        return bw, f32, name
    # an unlisted card is held to the H100 SXM5 figures, and says so
    bw, f32 = CARDS["NVIDIA H100 80GB HBM3"]
    return bw, f32, "NVIDIA H100 80GB HBM3 (assumed)"


def time_ms(fn, reps: int = TIMING_REPS, before=None) -> float:
    """Median device milliseconds of ``fn()`` on the current stream, after
    warm-up; ``before()`` runs ahead of each timed call, outside the timed
    window.  A spin kernel ahead of the start event keeps the device busy
    while the host enqueues ``fn``, so host launch overhead is not timed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median host-clock milliseconds of ``fn()`` from an idle device to the
    device's end of it (for stages that include host work)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def shifted_ids(ids, offsets):
    """Per-feature ids [B, F, P] -> combined-table bags [B*F, P] (numpy),
    the shift ``embedding_bag_local`` applies before K1."""
    import numpy as np

    out = np.where(ids >= 0, ids + offsets[None, :-1, None].astype(np.int32), -1)
    return out.reshape(-1, ids.shape[2]).astype(np.int32)


def check(name, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want``; raises past
    ``|got - want| <= tol + tol * |want|`` (assert_allclose's rule)."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements past tolerance "
                             f"{tol}, max abs err {float(err.max())}")
    return float(err.max())


def measure_k1(table, ids, bw: float, f32_rate: float) -> dict:
    """Kernel, plain and library times of K1 on ``table``/``ids`` and the
    card's bound for the same work."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops, ref

    valid = ids >= 0
    flat = ids[valid].long()                           # built outside timing
    offsets = torch.zeros(ids.shape[0], dtype=torch.long, device=ids.device)
    offsets[1:] = valid.sum(dim=1).cumsum(0)[:-1]
    esize = table.element_size()
    D = table.shape[1]
    n_valid = int(flat.numel())
    distinct = int(torch.unique(flat).numel())
    n_bytes = distinct * D * esize + ids.numel() * 4 + ids.shape[0] * D * esize
    n_ops = n_valid * D                                # fp32 adds
    t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / f32_rate * 1e3
    # twice the 50 MB L2, rewritten before each call to evict the table rows
    scrub = torch.empty(100 * 2**20 // 4, device=ids.device)
    return {
        "ms": time_ms(lambda: ops.hot_embedding_bag(table, ids)),
        "ms_cold_l2": time_ms(lambda: ops.hot_embedding_bag(table, ids),
                              before=scrub.zero_),
        "plain_ms": time_ms(lambda: ref.hot_embedding_bag_ref(table, ids)),
        "library_ms": time_ms(lambda: F.embedding_bag(
            flat, table, offsets, mode="sum")),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "distinct_rows": distinct,
        "valid_ids": n_valid,
        "bytes": n_bytes,
    }


def phase_kernel(dev, bw: float, f32_rate: float, cfg, big_cfg) -> dict:
    """K1 against its plain version at ``cfg``'s launch shape (f32) and on
    a bf16 table shaped like ``big_cfg``'s (the run: dlrm-rmc1 prod and
    dlrm-rm2 FULL)."""
    import numpy as np
    import torch

    from repro_torch.data.clicklog import ClickLogGenerator
    from repro_torch.kernels.embedding_bag import ops, ref

    g = torch.Generator(dev).manual_seed(7)
    results = {}

    # (a) the main path's launch shape: d = 1024 items x F bags x P
    emb = cfg.embedding
    ids_np = shifted_ids(ClickLogGenerator(cfg, seed=3).sparse_ids(1024),
                         emb.row_offsets)
    table = torch.empty((emb.total_rows, emb.dim), device=dev).uniform_(
        -1.0, 1.0, generator=g)
    ids = torch.from_numpy(ids_np).to(dev)
    err = check("rmc1", ops.hot_embedding_bag(table, ids),
                ref.hot_embedding_bag_ref(table, ids), F32_TOL)
    torch.cuda.synchronize()
    rmc1_case = {"case": "rmc1_prod", "table": list(table.shape),
                 "dtype": "float32", "bags": ids.shape[0], "P": ids.shape[1],
                 "max_abs_err": err, "tolerance": F32_TOL,
                 **measure_k1(table, ids, bw, f32_rate)}
    emit({"phase": "kernel", **rmc1_case})
    results["rmc1"] = rmc1_case

    # (b) 37 bags (no batch padding) and all-padding bags, same table
    ids37 = ids[:37].clone()
    ids37[[0, 5, 36]] = -1
    out37 = ops.hot_embedding_bag(table, ids37)
    err37 = check("B=37", out37, ref.hot_embedding_bag_ref(table, ids37),
                  F32_TOL)
    if out37[[0, 5, 36]].abs().max().item() != 0.0:
        raise AssertionError("all-padding bags did not pool to exactly zero")
    emit({"phase": "kernel", "case": "b37_with_empty_bags", "bags": 37,
          "max_abs_err": err37, "empty_bags_zero": True})
    del table, ids, ids37, out37
    torch.cuda.empty_cache()

    # (c) dlrm-rm2 FULL-shaped bf16 table: 130,000,384 x 64 (8.3e9 elements)
    full = big_cfg.embedding
    ids_np = shifted_ids(ClickLogGenerator(big_cfg, seed=4).sparse_ids(1024),
                         full.row_offsets)
    H = full.total_rows
    ids_np[:4, :16] = (H - 1 - np.arange(64)).reshape(4, 16)  # the last rows
    table = torch.empty((H, full.dim), dtype=torch.bfloat16, device=dev)
    table.uniform_(-1.0, 1.0, generator=g)
    ids = torch.from_numpy(ids_np).to(dev)
    err = check("rm2_full_bf16", ops.hot_embedding_bag(table, ids),
                ref.hot_embedding_bag_ref(table, ids), BF16_TOL)
    torch.cuda.synchronize()
    rm2_case = {"case": "rm2_full_bf16", "table": list(table.shape),
                "dtype": "bfloat16", "elements": H * full.dim,
                "max_row_id": int(ids_np.max()), "bags": ids.shape[0],
                "P": ids.shape[1], "max_abs_err": err, "tolerance": BF16_TOL,
                **measure_k1(table, ids, bw, f32_rate)}
    emit({"phase": "kernel", **rm2_case})
    results["rm2"] = rm2_case
    del table, ids
    torch.cuda.empty_cache()
    return results


def phase_serve(dev, cfg) -> dict:
    """The main path: ``cfg`` served behind dlrm-rmc1's schedule on T2."""
    import torch

    from repro_torch.configs.paper_models import paper_profile
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch.serve_recsys import serve
    from repro_torch.models import dlrm
    from repro_torch.models.recsys_base import batch_to_tensors

    model = dlrm.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                      device=dev)
    ops.launches = 0
    out = serve(cfg, paper_profile("dlrm-rmc1"), "T2", device=dev,
                n_queries=SERVE_QUERIES, qps=SERVE_QPS, seed=0, model=model,
                keep_launches=1)
    launches = ops.launches
    expected = out["fused_launches"] + out["warmup_launches"]
    if not (launches > 0 and launches == expected == out["k1_launches"]):
        raise AssertionError(f"K1 launches {launches} (serve counted "
                             f"{out['k1_launches']}), expected {expected}")

    # one fused batch again, K1 replaced by its plain version, on the card
    batch_np, scores = out["kept"][0]
    emb = cfg.embedding
    with torch.inference_mode():
        batch = batch_to_tensors(batch_np, dev)
        ids = torch.from_numpy(shifted_ids(batch_np["sparse_ids"],
                                           emb.row_offsets)).to(dev)
        pooled = ref.hot_embedding_bag_ref(model.table, ids).reshape(
            -1, emb.num_features, emb.dim)
        plain = model.apply_dense_given_pooled(batch, pooled)
    d = out["schedule"]["batch"]
    if scores.shape != (d,):
        raise AssertionError(f"scores shape {scores.shape}, expected ({d},)")
    err = check("serve logits", torch.from_numpy(scores), plain.float().cpu(),
                LOGIT_TOL)

    # where one fused launch's time goes (host clock, device idle between)
    with torch.inference_mode():
        pooled = model.apply_sparse(batch)
        logits = model.apply_dense_given_pooled(batch, pooled)
        stages = {
            "launch_ms": host_ms(
                lambda: model(batch_to_tensors(batch_np, dev)).float().cpu()),
            "h2d_ms": host_ms(lambda: batch_to_tensors(batch_np, dev)),
            "sparse_k1_ms": host_ms(lambda: model.apply_sparse(batch)),
            "dense_ms": host_ms(
                lambda: model.apply_dense_given_pooled(batch, pooled)),
            "d2h_ms": host_ms(lambda: logits.float().cpu()),
        }
    return {
        "phase": "serve", "model": cfg.name,
        "table_gb": model.table.numel() * model.table.element_size() / 1e9,
        "schedule": out["schedule"], "served_queries": out["served_queries"],
        "items": out["items"], "fused_launches": out["fused_launches"],
        "warmup_launches": out["warmup_launches"], "k1_launches": launches,
        "p50_ms": out["p50_ms"], "p95_ms": out["p95_ms"],
        "p99_ms": out["p99_ms"], "wall_s": out["wall_s"],
        "logits_max_abs_err_vs_plain": err, "logit_tolerance": LOGIT_TOL,
        "fused_launch_breakdown": stages,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bw, f32_rate, rates_of = card_rates(name)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "hbm_bytes_per_s": bw, "f32_flops": f32_rate, "rates_of": rates_of})

    # 2. build
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "built": v["built"],
                          "ptxas": [ln for ln in v["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for k, v in built.items()}})

    from repro_torch.configs import dlrm_rm2
    from repro_torch.configs.paper_models import rmc1

    dev = torch.device("cuda")
    # 3. kernel
    k1 = phase_kernel(dev, bw, f32_rate, rmc1(True), dlrm_rm2.FULL)

    # 4. serve (the main path; the K1 count is reset inside, just before it)
    serve_line = phase_serve(dev, rmc1(True))
    emit(serve_line)

    m = k1["rmc1"]
    emit({"kernels": [{
        "name": "hot_embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:43",
        "launches": serve_line["k1_launches"],
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "shape": f"table {m['table'][0]}x{m['table'][1]} f32, "
                 f"{m['bags']} bags x P={m['P']}",
        "tolerance": m["tolerance"],
    }], "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
