#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - the card (nvidia-smi name and power limit), TF32 switched off;
  2. build   - nvcc builds every CUDA source of the port for sm_90a, one
               process per source, all at once;
  3. kernel  - kernel K1 (hot embedding bag) against its plain PyTorch
               version on the card: the dlrm-rmc1 production launch shape
               (f32), a batch of 37 bags and all-padding bags, the
               per-feature entry at the rmc1 launch (ids [1024, 10, 80],
               bitwise the 2-D entry on the shifted ids, an unrouted
               feature exactly zero), a dlrm-rm2 FULL-shaped bf16 table
               past 2**31 elements (its last rows included) and the
               dlrm-rmc3 production launch (19.2 GB f32 table, P = 30);
               timed with CUDA events with a warm L2 (``ms``), with 100 MB
               written (``ms_cold_l2``) or read (``ms_cold_clean``) before
               each launch, and over 8 distinct click-log launches in turn
               (``ms_stream``), beside the plain version, torch's
               embedding_bag and the card's bandwidth bound;
  4. serve   - the DLRM path: dlrm-rmc1 at production width served behind
               its Hercules schedule (``repro_torch.launch.serve_recsys``),
               with K1's launch count checked against the fused launches (one
               per fused launch, through the per-feature entry), one fused
               batch's logits checked against the plain path, and one fused
               launch's stages timed on the host clock;
  5. decode_kernel - kernel K3 (split-KV flash decode) against its plain
               version at the decode_32k attention shape (q [16, 1, 24, 128],
               k/v [16, 32768, 8, 128] bf16), a kv_len inside a split with a
               nonzero kv_offset, a slice wholly past kv_len (its partial must
               be exactly empty) and an f32 case; timed beside the plain
               version, SDPA and the bandwidth bound.  Then K3's int8 entry
               on a random int8 cache of the same shape (scales in [0.005,
               0.02]): every row live, a ragged kv_len, a shard slice whose
               kv_len ends inside a split, f32 q; each against its plain
               version and bitwise against the bf16/f32 entry on the cache
               dequantised eagerly; timed beside its plain version, the
               eager dequantisation plus the bf16 entry (the path before it)
               and its bandwidth bound; the same at the LM tenant's shape
               (q [4, 1, 24, 128], a 2048-row int8 cache), with the split
               plan taken there; and the bf16 entry at head size 32 (its
               CUDA-core variant);
  6. attention_kernel - kernel K2 (flash attention) against attention_ref
               at q [1, 4096, 24, 128], k/v [1, 4096, 8, 128] bf16 causal, an
               f32 case and a q_offset case; at the prefill_32k head shape
               (Tq = Tk = 32768), where the plain version cannot run whole
               (103 GB of scores), on its first 128 and last 256 query rows;
               K2 and SDPA timed at both shapes;
  7. lm      - the LM path, llama3.2-3b FULL in bf16 with the int8 KV cache
               (random weights from a seed) through ``repro_torch.launch.steps``
               and ``repro_torch.models.transformer``: (a) the prefill_32k
               cell at batch 1 (cut from 32: the reference's all-position
               logits would be 269 GB), (b) the decode_32k cell at batch 16
               (cut from 128: the int8 cache alone would be 240 GB), one step
               at pos = S - 1 over a random int8 cache, with 28 launches of
               K3's int8 entry (no eager dequantisation: the step's memory
               above its inputs stays below one dequantised layer) and K3
               held to its plain version at each call, (c) the LM tenant
               answering 4 prompts of 1024 tokens with 32 greedy decode
               steps, K3 held to its plain version at each of its 896 calls,
               one more step under torch.profiler (device busy, idle share),
               (d) the steps of (b) and (c) in f32, K3 held to its plain
               version at each call, their logits held to the same path
               with K3 replaced by its plain version;
  8. cluster - kernel K4 (the fleet FIFO solver) and the Hercules cluster
               day through ``repro_torch.serving.scenarios``: (a) K4 at
               benchmarks/bench_cluster.py's fleet shape (512 streams, k in
               {2, 4, 8, 16}, 199,444 jobs), every stream bitwise
               ``engine._sweep`` and K4's plain version, with planted
               one-ulp faults; timed alone, through ``fleet_fifo_finish``
               and against the sequential sweep; (b) the smoke event-core
               day (``baseline_day``, cap 20,000), as it is (no wide group:
               no K4 launch) and with ``_MIN_FLEET_WIDTH`` = 1 (every
               call through K4), each bitwise the same day on the CPU and
               every fleet call bitwise ``_sweep``; (c) the full-width
               event-core day (all six workloads x all eleven server
               types, cut from 96 to 24 intervals, cap 200,000) from an
               empty profile cache, every fleet call bitwise ``_sweep``,
               with the bridged days' Hercules-vs-greedy peak power.
Every attention-kernel check is also shown to fail planted faults (zeros,
half the keys, the wrong KV head, the causal mask flipped, and for the int8
entry each row read with the next row's scales); the kernel phases feed
peaked queries so that attention outputs are O(1) against the bf16
tolerance.
Then the kernel summary line (K1, K2, K3, K3's int8 entry and K4), the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits 2 before any phase.
"""
from __future__ import annotations

import contextlib
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
STREAM_LAUNCHES = 8  # distinct click-log launches K1 meets in turn
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers host enqueue
F32_TOL = 1e-5    # tests/test_kernels.py tolerances
BF16_TOL = 3e-2
ATTN_F32_TOL = 2e-4  # attention kernels in f32 (tests/test_kernels.py)
LOGIT_TOL = 1e-4  # fp32 sums in another order inside the MLPs
BF16_PEAK = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
LM_ARCH = "llama3.2-3b"
PREFILL_BATCH = 1    # prefill_32k cut 32 -> 1 for one card
DECODE_BATCH = 16    # decode_32k cut 128 -> 16 for one card
GEN_PROMPTS, GEN_CACHE, GEN_STEPS = 4, 2048, 32  # prompts of LM_CONTEXT
# llama3.2-3b's attention heads, query / KV, and head size; the kernel
# phases' sequence lengths (the decode_32k and prefill_32k cells, and the
# longest causal length the plain attention can hold: 1.6 GB of scores)
HEADS, KV_HEADS, HEAD_DIM = 24, 8, 128
LONG_SEQ, ATTN_SEQ = 32768, 4096
# K2 at LONG_SEQ is held on its first and last query rows (the last slice's
# f32 scores against every key: [1, 8, 3, 256, 32768], 0.8 GB)
PREFILL_HEAD, PREFILL_TAIL = 128, 256
# The kernel phases scale q by 8 (exact in bf16): scores of std 8 put most
# of each softmax row on a few keys, so the attention outputs are O(1) and
# the bf16 tolerance tells a wrong key set, mask or head from rounding.
PEAK = 8.0
# The LM path in f32 against the same path with K3 replaced by its plain
# version: f32 sums in another order inside K3 (~1e-7), amplified by 28
# layers and by int8 cache codes they flip (a code moves 1/127 of its row).
F32_PATH_TOL = 1e-3

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
    """Max abs error of ``got`` against ``want``.  Raises past
    ``|got - want| <= tol + tol * |want|`` at any element (assert_allclose's
    rule) or past ``max |got - want| <= tol * max |want|``: the second ties
    the tolerance to the scale of what is compared, so an output of zeros,
    or one that lost a share of its keys, fails however small the values."""
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
    scale = float(w.abs().max())
    if float(err.max()) > tol * scale:
        raise AssertionError(f"{name}: max abs err {float(err.max())} past "
                             f"{tol} x max |want| {scale}")
    return float(err.max())


def must_fail(name, wrong, want, tol) -> None:
    """A negative control of ``check``: ``wrong``, a planted fault, must
    fail it."""
    try:
        check(name, wrong, want, tol)
    except AssertionError:
        return
    raise AssertionError(f"{name}: a planted fault passed the check")


def k3_controls(name, want, q, k, v, tol, *, kv_len, **kw) -> None:
    """Planted faults of K3's output on these inputs, each of which the
    check must fail: zeros, half of the live keys dropped, and the next
    KV head's keys and values."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    base = kw.get("kv_offset", 0)
    must_fail(f"{name}, zeros", torch.zeros_like(want), want, tol)
    must_fail(f"{name}, half the keys",
              ref.flash_decode_ref(q, k, v, kv_len=base + (kv_len - base) // 2,
                                   **kw), want, tol)
    must_fail(f"{name}, wrong KV head",
              ref.flash_decode_ref(q, k.roll(1, dims=2), v.roll(1, dims=2),
                                   kv_len=kv_len, **kw), want, tol)


def k3_int8_controls(name, want, q, kq, ks, vq, vs, tol, *, kv_len,
                     **kw) -> None:
    """Planted faults of K3's int8 entry on these inputs, each of which the
    check must fail: zeros, half of the live keys dropped, the next KV
    head's keys, values and scales, and each row read with the next row's
    scales."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    base = kw.get("kv_offset", 0)
    must_fail(f"{name}, zeros", torch.zeros_like(want), want, tol)
    must_fail(f"{name}, half the keys", ref.flash_decode_int8_ref(
        q, kq, ks, vq, vs, kv_len=base + (kv_len - base) // 2, **kw), want,
        tol)
    must_fail(f"{name}, wrong KV head", ref.flash_decode_int8_ref(
        q, *(t.roll(1, dims=2) for t in (kq, ks, vq, vs)), kv_len=kv_len,
        **kw), want, tol)
    must_fail(f"{name}, next row's scales", ref.flash_decode_int8_ref(
        q, kq, ks.roll(-1, dims=1), vq, vs.roll(-1, dims=1), kv_len=kv_len,
        **kw), want, tol)


def int8_case(name, q, kq, ks, vq, vs, tol, *, kv_len, **kw) -> float:
    """K3's int8 entry against its plain version (then its planted faults),
    and bitwise against the entry in q's dtype on the cache dequantised
    eagerly: the two share one kernel template and one split plan."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    got = ops.flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len, **kw)
    want = ref.flash_decode_int8_ref(q, kq, ks, vq, vs, kv_len=kv_len, **kw)
    err = check(name, got, want, tol)
    k3_int8_controls(name, want, q, kq, ks, vq, vs, tol, kv_len=kv_len, **kw)
    same = ops.flash_decode(q, ref.dequantize_kv(kq, ks, q.dtype),
                            ref.dequantize_kv(vq, vs, q.dtype),
                            kv_len=kv_len, **kw)
    if not bool(torch.equal(got, same)):
        raise AssertionError(f"{name}: the int8 entry differs from the "
                             f"{q.dtype} entry on the dequantised cache")
    return err


def measure_k1(table, ids, bw: float, f32_rate: float, stream=()) -> dict:
    """Kernel, plain and library times of K1 on ``table``/``ids`` and the
    card's bound for the same work.  ``ms`` repeats one launch (its rows
    stay in the 50 MB L2); ``ms_cold_l2`` writes 100 MB before each launch
    (none of the rows stay in L2, and the launch writes back the 50 MB of
    dirty lines it evicts); ``ms_cold_clean`` reads 100 MB instead (none
    of the rows, nothing to write back); ``ms_stream`` is a launch's share
    of K1 over the id sets of ``stream`` in turn, each finding the L2 as
    the one before left it."""
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
    # twice the 50 MB L2, written or read before each call to evict the rows
    scrub = torch.empty(100 * 2**20 // 4, device=ids.device)
    res = {
        "ms": time_ms(lambda: ops.hot_embedding_bag(table, ids)),
        "ms_cold_l2": time_ms(lambda: ops.hot_embedding_bag(table, ids),
                              before=scrub.zero_),
        "ms_cold_clean": time_ms(lambda: ops.hot_embedding_bag(table, ids),
                                 before=scrub.sum),
        "plain_ms": time_ms(lambda: ref.hot_embedding_bag_ref(table, ids)),
        "library_ms": time_ms(lambda: F.embedding_bag(
            flat, table, offsets, mode="sum")),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "distinct_rows": distinct,
        "valid_ids": n_valid,
        "bytes": n_bytes,
    }
    if stream:
        res["ms_stream"] = time_ms(
            lambda: [ops.hot_embedding_bag(table, s) for s in stream]
        ) / len(stream)
        res["stream_launches"] = len(stream)
    res["cold_share_of_bound"] = res["bound_ms"] / res["ms_cold_l2"]
    return res


def click_launches(cfg, seeds):
    """One fused launch's click-log ids [1024, F, P] (numpy) per seed."""
    from repro_torch.data.clicklog import ClickLogGenerator

    return [ClickLogGenerator(cfg, seed=s).sparse_ids(1024) for s in seeds]


def k1_stream(cfg, dev):
    """STREAM_LAUNCHES distinct launches' combined-table bags on ``dev``."""
    import torch

    rows = cfg.embedding.row_offsets
    return [torch.from_numpy(shifted_ids(i, rows)).to(dev) for i in
            click_launches(cfg, range(100, 100 + STREAM_LAUNCHES))]


def k1_table(dev, emb, dtype, g):
    import torch

    return torch.empty((emb.total_rows, emb.dim), dtype=dtype,
                       device=dev).uniform_(-1.0, 1.0, generator=g)


def k1_features_case(table, ids3, offsets, flat_out) -> dict:
    """K1's per-feature entry at one launch's ids [B, F, P]: against its
    plain version, bitwise against the 2-D entry's ``flat_out`` on the
    shifted ids, and with feature 4 unrouted (exactly zero there, the other
    features unchanged)."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref

    got = ops.embedding_bag_features(table, ids3, offsets)
    err = check("features entry", got,
                ref.embedding_bag_features_ref(table, ids3, offsets), F32_TOL)
    if not bool(torch.equal(got.reshape(flat_out.shape), flat_out)):
        raise AssertionError("the features entry differs from the 2-D entry "
                             "on the shifted ids")
    unrouted = offsets.clone()
    unrouted[4] = -1
    part = ops.embedding_bag_features(table, ids3, unrouted)
    keep = [f for f in range(ids3.shape[1]) if f != 4]
    if part[:, 4].abs().max().item() != 0.0 or not bool(
            torch.equal(part[:, keep], got[:, keep])):
        raise AssertionError("an unrouted feature did not pool to exactly "
                             "zero, or moved the others")
    torch.cuda.synchronize()
    return {"max_abs_err": err, "tolerance": F32_TOL,
            "bitwise_equal_2d": True, "unrouted_feature_zero": True,
            "ms": time_ms(lambda: ops.embedding_bag_features(
                table, ids3, offsets))}


def phase_kernel(dev, bw: float, f32_rate: float, cfg, big_cfg,
                 deep_cfg) -> dict:
    """K1 against its plain version at ``cfg``'s launch shape (f32, through
    both entries), on a bf16 table shaped like ``big_cfg``'s and at
    ``deep_cfg``'s launch shape (f32) (the run: dlrm-rmc1 prod, dlrm-rm2
    FULL and dlrm-rmc3 prod)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.embedding import routed_offsets

    g = torch.Generator(dev).manual_seed(7)
    results = {}

    # (a) the main path's launch shape: d = 1024 items x F bags x P
    emb = cfg.embedding
    ids3_np = click_launches(cfg, [3])[0]
    table = k1_table(dev, emb, torch.float32, g)
    ids = torch.from_numpy(shifted_ids(ids3_np, emb.row_offsets)).to(dev)
    flat_out = ops.hot_embedding_bag(table, ids)
    err = check("rmc1", flat_out, ref.hot_embedding_bag_ref(table, ids),
                F32_TOL)
    torch.cuda.synchronize()
    rmc1_case = {"case": "rmc1_prod", "table": list(table.shape),
                 "dtype": "float32", "bags": ids.shape[0], "P": ids.shape[1],
                 "max_abs_err": err, "tolerance": F32_TOL,
                 **measure_k1(table, ids, bw, f32_rate, k1_stream(cfg, dev))}
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

    # (c) the per-feature entry at the same launch: ids [1024, 10, 80] as
    # the serving path passes them, the offsets added inside the kernel
    ids3 = torch.from_numpy(ids3_np).to(dev)
    feat = k1_features_case(table, ids3, routed_offsets(emb, dev), flat_out)
    emit({"phase": "kernel", "case": "rmc1_prod_features",
          "ids": list(ids3.shape), **feat})
    results["features"] = feat
    del table, ids, ids37, out37, ids3, flat_out
    torch.cuda.empty_cache()

    # (d) dlrm-rm2 FULL-shaped bf16 table: 130,000,384 x 64 (8.3e9 elements)
    full = big_cfg.embedding
    ids_np = shifted_ids(click_launches(big_cfg, [4])[0], full.row_offsets)
    H = full.total_rows
    ids_np[:4, :16] = (H - 1 - np.arange(64)).reshape(4, 16)  # the last rows
    table = k1_table(dev, full, torch.bfloat16, g)
    ids = torch.from_numpy(ids_np).to(dev)
    err = check("rm2_full_bf16", ops.hot_embedding_bag(table, ids),
                ref.hot_embedding_bag_ref(table, ids), BF16_TOL)
    torch.cuda.synchronize()
    rm2_case = {"case": "rm2_full_bf16", "table": list(table.shape),
                "dtype": "bfloat16", "elements": H * full.dim,
                "max_row_id": int(ids_np.max()), "bags": ids.shape[0],
                "P": ids.shape[1], "max_abs_err": err, "tolerance": BF16_TOL,
                **measure_k1(table, ids, bw, f32_rate,
                             k1_stream(big_cfg, dev))}
    emit({"phase": "kernel", **rm2_case})
    results["rm2"] = rm2_case
    del table, ids
    torch.cuda.empty_cache()

    # (e) dlrm-rmc3 prod: 10 x 15,000,000 x 32 f32 (19.2 GB), P = 30
    deep = deep_cfg.embedding
    ids = torch.from_numpy(shifted_ids(click_launches(deep_cfg, [5])[0],
                                       deep.row_offsets)).to(dev)
    table = k1_table(dev, deep, torch.float32, g)
    err = check("rmc3_prod", ops.hot_embedding_bag(table, ids),
                ref.hot_embedding_bag_ref(table, ids), F32_TOL)
    torch.cuda.synchronize()
    rmc3_case = {"case": "rmc3_prod", "table": list(table.shape),
                 "dtype": "float32", "bags": ids.shape[0], "P": ids.shape[1],
                 "max_abs_err": err, "tolerance": F32_TOL,
                 **measure_k1(table, ids, bw, f32_rate,
                              k1_stream(deep_cfg, dev))}
    emit({"phase": "kernel", **rmc3_case})
    results["rmc3"] = rmc3_case
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


def leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def attn_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_decode_kernel(dev, bw: float) -> dict:
    """K3 against its plain version on the card; times at the decode_32k
    attention shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    g = torch.Generator(dev).manual_seed(11)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    B, S, H, KVH, hd = DECODE_BATCH, LONG_SEQ, HEADS, KV_HEADS, HEAD_DIM
    q, k, v = rand(B, 1, H, hd) * PEAK, rand(B, S, KVH, hd), rand(B, S, KVH, hd)
    cases = {}

    # (a) the decode_32k shape, every row live
    out = ops.flash_decode(q, k, v, kv_len=S)
    want = ref.flash_decode_ref(q, k, v, kv_len=S)
    err = check("k3 decode_32k", out, want, BF16_TOL)
    k3_controls("k3 decode_32k", want, q, k, v, BF16_TOL, kv_len=S)
    parts = ops.flash_decode_partials(q, k, v, kv_len=S)
    want = ref.flash_decode_partials_ref(q, k, v, kv_len=S)
    for name, a, b in zip("mlo", parts, want):
        check(f"k3 partial {name}", a, b, BF16_TOL)
    torch.cuda.synchronize()
    cases["decode_32k"] = err

    # (b) a shard slice at kv_offset S / 32 whose kv_len ends inside a split
    off, kv_len = S // 32, S // 32 + S * 3 // 8 + 57
    ks, vs = k[:, :S // 2].contiguous(), v[:, :S // 2].contiguous()
    got = ops.flash_decode_partials(q, ks, vs, kv_len=kv_len, kv_offset=off)
    want = ref.flash_decode_partials_ref(q, ks, vs, kv_len=kv_len,
                                         kv_offset=off)
    errs = [check(f"k3 offset {n}", a, b, BF16_TOL)
            for n, a, b in zip("mlo", got, want)]
    want = ref.flash_decode_ref(q, ks, vs, kv_len=kv_len, kv_offset=off)
    errs.append(check("k3 offset", ops.flash_decode(
        q, ks, vs, kv_len=kv_len, kv_offset=off), want, BF16_TOL))
    k3_controls("k3 offset", want, q, ks, vs, BF16_TOL, kv_len=kv_len,
                kv_offset=off)
    cases["offset_ragged"] = max(errs)

    # (c) a slice wholly past kv_len: exactly the empty partial
    m, l, o = ops.flash_decode_partials(q, ks, vs, kv_len=S, kv_offset=S)
    if not (bool((l == 0).all()) and bool((o == 0).all())
            and bool((m == -1e30).all())):
        raise AssertionError("k3: a slice past kv_len gave a non-empty partial")
    cases["past_kv_len_exactly_empty"] = True
    del ks, vs

    # (d) f32
    qf, kf, vf = (rand(4, 1, H, hd, dtype=torch.float32) * PEAK,
                  rand(4, S // 8, KVH, hd, dtype=torch.float32),
                  rand(4, S // 8, KVH, hd, dtype=torch.float32))
    want = ref.flash_decode_ref(qf, kf, vf, kv_len=S // 11)
    cases["f32"] = check("k3 f32", ops.flash_decode(qf, kf, vf, kv_len=S // 11),
                         want, ATTN_F32_TOL)
    k3_controls("k3 f32", want, qf, kf, vf, ATTN_F32_TOL, kv_len=S // 11)
    torch.cuda.synchronize()
    del qf, kf, vf

    # times at (a); SDPA on [B, H, 1, hd] against [B, KVH, S, hd]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    n_bytes = attn_bytes(q, k, v, out)
    n_ops = 4 * B * H * S * hd          # QK^T and PV (bf16 tensor cores)
    t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / BF16_PEAK * 1e3
    res = {
        "phase": "decode_kernel", "shape": f"q [{B}, 1, {H}, {hd}], k/v "
        f"[{B}, {S}, {KVH}, {hd}] bf16, kv_len {S}",
        "max_abs_err": cases["decode_32k"], "tolerance": BF16_TOL,
        "cases": cases,
        "ms": time_ms(lambda: ops.flash_decode(q, k, v, kv_len=S)),
        "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, k, v, kv_len=S)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": n_bytes,
    }
    del k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # (e) the int8 entry (the LM path's): a random int8 cache with scales
    # in [0.005, 0.02], as phase_lm (b) makes; every row live, a ragged
    # kv_len, a shard slice whose kv_len ends inside a split, and f32 q
    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.empty(shape, device=dev).uniform_(0.005, 0.02,
                                                       generator=g)

    kq, vq = int8(B, S, KVH, hd), int8(B, S, KVH, hd)
    ks, vs = scales(B, S, KVH, 1), scales(B, S, KVH, 1)
    i8 = {"decode_32k": int8_case("k3 int8 decode_32k", q, kq, ks, vq, vs,
                                  BF16_TOL, kv_len=S)}
    i8["ragged"] = int8_case("k3 int8 ragged", q, kq, ks, vq, vs, BF16_TOL,
                             kv_len=S * 5 // 8 + 13)
    off, kv_len = S // 32, S // 32 + S * 3 // 8 + 57
    half = [t[:, :S // 2].contiguous() for t in (kq, ks, vq, vs)]
    i8["offset_ragged"] = int8_case("k3 int8 offset", q, *half, BF16_TOL,
                                    kv_len=kv_len, kv_offset=off)
    del half
    nf = min(4, B)
    qf = rand(nf, 1, H, hd, dtype=torch.float32) * PEAK
    small = [t[:nf, :S // 8].contiguous() for t in (kq, ks, vq, vs)]
    i8["f32"] = int8_case("k3 int8 f32", qf, *small, ATTN_F32_TOL,
                          kv_len=S // 11)
    del small, qf
    torch.cuda.synchronize()
    n_bytes = attn_bytes(q, kq, ks, vq, vs, out)
    t_bytes = n_bytes / bw * 1e3
    res["int8"] = {
        "shape": f"q [{B}, 1, {H}, {hd}] bf16, k/v [{B}, {S}, {KVH}, {hd}] "
                 f"int8, scales [{B}, {S}, {KVH}, 1] f32, kv_len {S}",
        "max_abs_err": i8["decode_32k"], "tolerance": BF16_TOL,
        "cases": i8, "bitwise_equal_to_bf16_entry_on_dequantised_cache": True,
        "ms": time_ms(lambda: ops.flash_decode_int8(q, kq, ks, vq, vs,
                                                    kv_len=S)),
        "plain_ms": time_ms(lambda: ref.flash_decode_int8_ref(
            q, kq, ks, vq, vs, kv_len=S), reps=5),
        # what the path ran before: the eager dequantisation, then K3
        "eager_dequant_then_k3_ms": time_ms(lambda: ops.flash_decode(
            q, ref.dequantize_kv(kq, ks, q.dtype),
            ref.dequantize_kv(vq, vs, q.dtype), kv_len=S), reps=5),
        "library_ms": None,
        "library_note": "no single PyTorch call attends over an int8 cache "
                        "with per-row scales",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": n_bytes,
    }
    del q, kq, vq, ks, vs, out
    torch.cuda.empty_cache()

    # (f) the LM tenant's shape (phase_lm (c)): GEN_PROMPTS queries against
    # a GEN_CACHE-row int8 cache at its last generation step's kv_len; the
    # int8 entry against the eager dequantisation of the whole cache (what
    # the path ran before) followed by the bf16 entry, and the split plan
    # both entries take there
    from repro_torch.configs.paper_models import LM_CONTEXT
    from repro_torch.kernels.flash_attention.flash_decode import split_plan

    Bt, kv_len = GEN_PROMPTS, LM_CONTEXT + GEN_STEPS
    q = rand(Bt, 1, H, hd) * PEAK
    kq, vq = int8(Bt, GEN_CACHE, KVH, hd), int8(Bt, GEN_CACHE, KVH, hd)
    ks, vs = scales(Bt, GEN_CACHE, KVH, 1), scales(Bt, GEN_CACHE, KVH, 1)
    err = int8_case("k3 int8 tenant", q, kq, ks, vq, vs, BF16_TOL,
                    kv_len=kv_len)
    live = [t[:, :kv_len] for t in (kq, ks, vq, vs)]
    t_bytes = attn_bytes(q, *live, q) / bw * 1e3
    t_ops = 4 * Bt * H * kv_len * hd / BF16_PEAK * 1e3
    split_len, n_splits = split_plan(kv_len, Bt * KVH)
    res["int8_tenant"] = {
        "shape": f"q [{Bt}, 1, {H}, {hd}] bf16, k/v [{Bt}, {GEN_CACHE}, {KVH}, "
                 f"{hd}] int8, kv_len {kv_len}",
        "max_abs_err": err, "tolerance": BF16_TOL,
        "split_len": split_len, "n_splits": n_splits,
        "blocks": Bt * KVH * n_splits,
        "ms": time_ms(lambda: ops.flash_decode_int8(q, kq, ks, vq, vs,
                                                    kv_len=kv_len)),
        "eager_dequant_then_k3_ms": time_ms(lambda: ops.flash_decode(
            q, ref.dequantize_kv(kq, ks, q.dtype),
            ref.dequantize_kv(vq, vs, q.dtype), kv_len=kv_len)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    del q, kq, vq, ks, vs, live

    # (g) bf16 at a head size off the tensor-core variant (its CUDA-core one)
    hs = 32
    q, k, v = (rand(4, 1, H, hs) * PEAK, rand(4, S // 8, KVH, hs),
               rand(4, S // 8, KVH, hs))
    want = ref.flash_decode_ref(q, k, v, kv_len=S // 11)
    res["bf16_head_dim_32"] = check("k3 bf16 hd 32", ops.flash_decode(
        q, k, v, kv_len=S // 11), want, BF16_TOL)
    k3_controls("k3 bf16 hd 32", want, q, k, v, BF16_TOL, kv_len=S // 11)
    torch.cuda.synchronize()
    del q, k, v
    torch.cuda.empty_cache()
    return res


def phase_attention_kernel(dev, bw: float) -> dict:
    """K2 against attention_ref on the card; K2 and SDPA alone at the
    prefill_32k head shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    g = torch.Generator(dev).manual_seed(12)
    H, KVH, hd = HEADS, KV_HEADS, HEAD_DIM

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def sdpa(q, k, v):
        """SDPA's causal call on [B, H, T, hd], K/V expanded to H heads
        beforehand (outside the timing), so its flash backend serves it."""
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KVH, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)

    def bound(q, k, v, causal_ops):
        t_ops = causal_ops / BF16_PEAK * 1e3
        t_bytes = attn_bytes(q, k, v, q) / bw * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def k2_slice(name, got, q, k, v, tol, *, causal=True, q_offset=0):
        """K2's output ``got`` against attention_ref on the same values in
        f32 (in bf16 the plain version rounds scores of this size, up to
        ~40, by up to 0.25 before its softmax), then the planted faults the
        check must fail: zeros, the causal mask flipped, the next KV head."""
        def plain(q, k, v, causal=causal):
            return ref.attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal, q_offset=q_offset)

        want = plain(q, k, v)
        err = check(name, got, want, tol)
        must_fail(f"{name}, zeros", torch.zeros_like(want), want, tol)
        must_fail(f"{name}, causal flipped", plain(q, k, v, not causal),
                  want, tol)
        must_fail(f"{name}, wrong KV head",
                  plain(q, k.roll(1, dims=2), v.roll(1, dims=2)), want, tol)
        return err

    def k2_case(name, q, k, v, tol, *, causal=True, q_offset=0) -> float:
        """K2 on q, k, v held as ``k2_slice`` holds it."""
        got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        return k2_slice(name, got, q, k, v, tol, causal=causal,
                        q_offset=q_offset)

    cases = {}
    T = ATTN_SEQ
    q, k, v = rand(1, T, H, hd) * PEAK, rand(1, T, KVH, hd), rand(1, T, KVH, hd)
    cases["causal_bf16"] = k2_case("k2 causal", q, k, v, BF16_TOL)
    torch.cuda.synchronize()
    b_ms, b_by = bound(q, k, v, 4 * H * T * T * hd / 2)
    res = {"phase": "attention_kernel",
           "shape": f"q [1, {T}, {H}, {hd}], k/v [1, {T}, {KVH}, {hd}] bf16 "
                    "causal",
           "ms": time_ms(lambda: ops.flash_attention(q, k, v)),
           "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v)),
           "library_ms": time_ms(sdpa(q, k, v)),
           "bound_ms": b_ms, "bound_by": b_by}

    n = T // 4                       # queries after a 2n-token prefix
    qo, ko, vo = (rand(1, 2 * n, H, hd) * PEAK, rand(1, 4 * n, KVH, hd),
                  rand(1, 4 * n, KVH, hd))
    cases["q_offset_bf16"] = k2_case("k2 q_offset", qo, ko, vo, BF16_TOL,
                                     q_offset=2 * n)
    qf, kf, vf = (t[:, :n].float().contiguous() for t in (q, k, v))
    cases["causal_f32"] = k2_case("k2 f32", qf, kf, vf, ATTN_F32_TOL)
    cases["noncausal_f32"] = k2_case("k2 f32 non-causal", qf, kf, vf,
                                     ATTN_F32_TOL, causal=False)
    torch.cuda.synchronize()
    del q, k, v, qo, ko, vo, qf, kf, vf
    torch.cuda.empty_cache()

    # the prefill_32k head shape: the whole output is too large for the
    # plain version (103 GB of scores), so it is held on two query slices:
    # the first PREFILL_HEAD rows against the first keys, and the last
    # PREFILL_TAIL rows (q_offset T - PREFILL_TAIL) against every key
    T = LONG_SEQ
    q, k, v = rand(1, T, H, hd) * PEAK, rand(1, T, KVH, hd), rand(1, T, KVH, hd)
    out = ops.flash_attention(q, k, v)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("k2 prefill_32k: non-finite output")
    a, z = PREFILL_HEAD, T - PREFILL_TAIL
    cases["prefill_32k_head"] = k2_slice(
        "k2 prefill_32k head", out[:, :a], q[:, :a], k[:, :a], v[:, :a],
        BF16_TOL)
    cases["prefill_32k_tail"] = k2_slice(
        "k2 prefill_32k tail", out[:, z:], q[:, z:], k, v, BF16_TOL,
        q_offset=z)
    torch.cuda.synchronize()
    b_ms, b_by = bound(q, k, v, 4 * H * T * T * hd / 2)
    res["prefill_32k"] = {
        "shape": f"q [1, {T}, {H}, {hd}], k/v [1, {T}, {KVH}, {hd}] bf16 "
                 "causal",
        "ms": time_ms(lambda: ops.flash_attention(q, k, v), reps=5),
        "library_ms": time_ms(sdpa(q, k, v), reps=5),
        "plain_ms": None,  # [1, 8, 3, 32768, 32768] f32 scores: 103 GB
        "bound_ms": b_ms, "bound_by": b_by}
    res["cases"] = cases
    res["max_abs_err"] = cases["causal_bf16"]
    res["tolerance"] = BF16_TOL
    del q, k, v, out
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def swap_k3(fn, fn_int8):
    """The LM path with K3's wrappers in ``repro_torch.dist.decode``
    (``flash_decode``, and ``flash_decode_int8``, which the int8 cache
    path calls) replaced by ``fn`` and ``fn_int8`` for the duration."""
    from repro_torch.dist import decode

    saved = decode.flash_decode, decode.flash_decode_int8
    decode.flash_decode, decode.flash_decode_int8 = fn, fn_int8
    try:
        yield saved
    finally:
        decode.flash_decode, decode.flash_decode_int8 = saved


def plain_k3():
    """K3 replaced by its plain versions (on the card)."""
    from repro_torch.kernels.flash_attention import ref

    return swap_k3(ref.flash_decode_ref, ref.flash_decode_int8_ref)


def nudged_plain_k3():
    """K3 replaced by its plain versions, with every element of the first
    call's output (the first layer's attention) moved by one bf16 ulp."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    calls = []

    def nudge(plain):
        def fn(*args, **kw):
            out = plain(*args, **kw)
            if not calls:
                out = (out.view(torch.int16) + 1).view(out.dtype)
            calls.append(1)
            return out
        return fn

    return swap_k3(nudge(ref.flash_decode_ref),
                   nudge(ref.flash_decode_int8_ref))


@contextlib.contextmanager
def k3_checked(errs: list):
    """K3 as on the path, held at every call to its plain version on the
    same inputs at the bf16 tolerance (the f32 tolerance for f32 q), with
    the planted faults of ``k3_controls`` / ``k3_int8_controls`` failing
    the same check; the kernel's output continues the path.  Each call's
    max abs error goes to ``errs``."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    def tol(q):
        return BF16_TOL if q.dtype == torch.bfloat16 else ATTN_F32_TOL

    def both(q, k, v, **kw):
        out = ops.flash_decode(q, k, v, **kw)
        want = ref.flash_decode_ref(q, k, v, **kw)
        name = f"K3 call {len(errs)}"
        errs.append(check(name, out, want, tol(q)))
        k3_controls(name, want, q, k, v, tol(q), **kw)
        return out

    def both_int8(q, kq, ks, vq, vs, **kw):
        out = ops.flash_decode_int8(q, kq, ks, vq, vs, **kw)
        want = ref.flash_decode_int8_ref(q, kq, ks, vq, vs, **kw)
        name = f"K3 int8 call {len(errs)}"
        errs.append(check(name, out, want, tol(q)))
        k3_int8_controls(name, want, q, kq, ks, vq, vs, tol(q), **kw)
        return out

    with swap_k3(both, both_int8):
        yield


def tree_map(fn, tree):
    """``fn`` applied to each tensor of a nested dict."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def drift(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def generate(params, cfg, cache, first, steps: int, *, fed=None, times=None):
    """``steps`` decode steps at positions LM_CONTEXT, LM_CONTEXT + 1, ...
    from the token ``first`` [B, 1], greedy or, given ``fed``, on those
    tokens (teacher forcing).  Returns each step's logits and the tokens
    fed; with ``times``, appends each step's host milliseconds from an idle
    device."""
    import torch

    from repro_torch.configs.paper_models import LM_CONTEXT
    from repro_torch.models import transformer as tf

    out, tokens, tok = [], [], first
    with torch.inference_mode():
        for t in range(steps):
            if fed is not None:
                tok = fed[t]
            tokens.append(tok)
            if times is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            logits, cache = tf.decode_step(params, tok, cache, LM_CONTEXT + t,
                                           cfg)
            if times is not None:
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)
            tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    return out, tokens


def prefill_prompts(params, cfg, prompts, dev):
    """The prompts prefilled into a cache of GEN_CACHE rows: the last
    logits, the cache, and the prefill's host milliseconds."""
    import torch

    from repro_torch.models import transformer as tf

    with torch.inference_mode():
        cache = tf.init_kv_cache(cfg, prompts.shape[0], GEN_CACHE, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = tf.prefill(params, prompts, cache, cfg)
        torch.cuda.synchronize()
    return last, cache, (time.perf_counter() - t0) * 1e3


def clone(tree):
    import torch

    with torch.inference_mode():
        return tree_map(torch.clone, tree)


def profile_step(fn, top: int = 8) -> dict:
    """One run of ``fn`` under torch.profiler: host wall time from an idle
    device to its end, the device's busy time (the sum of the device-side
    events, kernels and copies; one stream, so they do not overlap), the
    idle share of that wall time, and the ``top`` device events by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / wall_ms if rows else None,
            "top": [{"kernel": k[:80], "ms": ms, "count": n}
                    for k, ms, n in rows[:top]]}


def reset_k3(ops) -> None:
    """Set the launch counts of K3's two entries to 0."""
    ops.launches["flash_decode"] = ops.launches["flash_decode_int8"] = 0


def k3_count(ops) -> int:
    return ops.launches["flash_decode"] + ops.launches["flash_decode_int8"]


def phase_lm(dev) -> dict:
    """llama3.2-3b FULL: the prefill_32k and decode_32k cells on one card,
    the LM tenant serving a few greedy generations, then both decode runs
    in f32 held to the plain-K3 path."""
    import dataclasses

    import torch

    from repro_torch.configs.paper_models import LM_CONTEXT
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as tf

    g = torch.Generator(dev).manual_seed(0)
    pre = build_cell(LM_ARCH, "prefill_32k", dev, batch=PREFILL_BATCH)
    dec = build_cell(LM_ARCH, "decode_32k", dev, batch=DECODE_BATCH)
    cfg = dec.cfg
    if not (cfg.decode_impl == "flash" and cfg.kv_quant == "int8"
            and pre.cfg.attn_impl == "chunked"):
        raise AssertionError(f"unexpected cell configs {pre.cfg} / {cfg}")
    torch.cuda.reset_peak_memory_stats()
    params = pre.init_state(g)
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{cfg.param_count()}")
    res = {"phase": "lm", "model": LM_ARCH, "params": n_params,
           "weights_gb": n_params * 2 / 1e9}

    # (a) prefill_32k: batch 1, S = 32768
    tokens = torch.randint(0, cfg.vocab, (pre.batch, pre.seq_len),
                           generator=g, device=dev, dtype=torch.int32)
    reset_k3(ops)
    times = []
    for _ in range(2):               # the first run warms cuBLAS up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pre.run(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    logits = out["logits"]
    if tuple(logits.shape) != (pre.batch, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
    res["prefill_32k"] = {"batch": pre.batch, "seq_len": pre.seq_len,
                          "ms": times[-1], "first_ms": times[0],
                          "logits_finite": True,
                          "k3_launches": k3_count(ops)}
    del out, logits, tokens
    torch.cuda.empty_cache()

    # (b) decode_32k: batch 16, one step at pos = S - 1 over a random cache.
    # The step runs alone, K3's counts set to 0 just before it (the int8
    # cache goes through K3's int8 entry, 28 launches, and never through
    # the eager dequantisation: the step's transient memory stays below one
    # layer's dequantised K/V); then with K3 checked at each of its 28 calls
    # (bitwise equal to the first run);
    # then with K3 replaced by its plain version outright, and that plain
    # path again with the first layer's attention moved by one bf16 ulp.
    # The two logit differences are reported side by side; (d) holds the
    # same step in f32 to a tolerance.
    B, S = dec.batch, dec.seq_len
    specs = dec.batch_specs["cache"]
    cache = {name: torch.randint(-127, 128, spec.shape, generator=g,
                                 device=dev, dtype=torch.int8)
             for name, spec in specs.items() if spec.dtype == torch.int8}
    for name in ("ks", "vs"):
        cache[name] = torch.empty(specs[name].shape, device=dev).uniform_(
            0.005, 0.02, generator=g)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev,
                          dtype=torch.int32)
    batch = {"token": token, "cache": cache}
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    peak_before_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_k3(ops)
    got = dec.run(params, batch)["logits"]
    torch.cuda.synchronize()
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k3_step = ops.launches["flash_decode_int8"]
    if k3_step != cfg.n_layers or ops.launches["flash_decode"]:
        raise AssertionError(f"K3's int8 entry launched {k3_step} times in a "
                             f"decode step (bf16 entry "
                             f"{ops.launches['flash_decode']}), expected "
                             f"{cfg.n_layers} (and 0)")
    deq_gb = 2 * cache["k"][0].numel() * 2 / 1e9   # one layer's K/V in bf16
    if step_peak_gb - base_gb >= deq_gb:
        raise AssertionError(f"decode_32k step took {step_peak_gb - base_gb} "
                             f"GB above its inputs: a dequantised layer "
                             f"({deq_gb} GB) fits in it")
    layer_errs = []
    with k3_checked(layer_errs):
        checked = dec.run(params, batch)["logits"]
    if not bool(torch.equal(checked, got)):
        raise AssertionError("decode_32k: the checked step differs from the "
                             "step alone")
    with plain_k3():
        plain = dec.run(params, batch)["logits"]
    with nudged_plain_k3():
        nudged = dec.run(params, batch)["logits"]
    step_ms = host_ms(lambda: dec.run(params, batch), reps=5)
    with torch.inference_mode():   # one layer's dequantisation, alone
        deq_ms = time_ms(lambda: (cache["k"][0].to(torch.bfloat16)
                                  * cache["ks"][0].to(torch.bfloat16),
                                  cache["v"][0].to(torch.bfloat16)
                                  * cache["vs"][0].to(torch.bfloat16)), reps=5)
    res["decode_32k"] = {
        "batch": B, "seq_len": S, "pos": S - 1,
        "cache_gb": sum(t.numel() * t.element_size()
                        for t in cache.values()) / 1e9,
        "step_ms": step_ms, "k3_int8_launches": k3_step,
        "k3_vs_plain_max_abs_err_per_call": max(layer_errs),
        "tolerance": BF16_TOL, "planted_faults_failed": 4 * len(layer_errs),
        "logits_max_abs_err_plain_path": drift(got, plain),
        "logits_mean_abs_err_plain_path": float((got.float() - plain.float())
                                                .abs().mean()),
        "logits_max_abs_drift_plain_path_one_ulp": drift(nudged, plain),
        "logits_std": float(got.float().std()),
        "argmax_agreement_plain_path": float(
            (got.argmax(-1) == plain.argmax(-1)).float().mean()),
        # the pass the path no longer runs, timed for the record
        "dequant_ms_per_layer": deq_ms,
        "step_peak_gb": step_peak_gb,
        "step_transient_gb": step_peak_gb - base_gb,
        "dequantised_layer_gb": deq_gb}
    del got, checked, plain, nudged    # the cache stays for (d)
    torch.cuda.empty_cache()

    # (c) the LM tenant: 4 prompts of LM_CONTEXT tokens, 32 greedy steps
    # alone, K3's counts set to 0 just before them; then the same 32 steps
    # from the same prefilled cache, fed the same tokens, once with K3
    # checked at each call (bitwise equal to the first run) and once with
    # K3 replaced by its plain version.
    prompts = torch.randint(0, cfg.vocab, (GEN_PROMPTS, LM_CONTEXT),
                            generator=g, device=dev, dtype=torch.int32)
    last, gen_cache, prefill_ms = prefill_prompts(params, cfg, prompts, dev)
    prefilled = clone(gen_cache)
    first = last.argmax(dim=-1, keepdim=True).to(torch.int32)
    step_times = []
    reset_k3(ops)
    timed, fed = generate(params, cfg, gen_cache, first, GEN_STEPS,
                          times=step_times)
    torch.cuda.synchronize()
    gen_launches = ops.launches["flash_decode_int8"]
    gen_bf16 = ops.launches["flash_decode"]
    if gen_launches != cfg.n_layers * GEN_STEPS or gen_bf16:
        raise AssertionError(f"K3's int8 entry launched {gen_launches} times "
                             f"in {GEN_STEPS} steps (bf16 entry "
                             f"{ops.launches['flash_decode']}), expected "
                             f"{cfg.n_layers * GEN_STEPS} (and 0)")
    layer_errs = []
    with k3_checked(layer_errs):
        checked, _ = generate(params, cfg, clone(prefilled), first, GEN_STEPS,
                              fed=fed)
    if len(layer_errs) != cfg.n_layers * GEN_STEPS:
        raise AssertionError(f"{len(layer_errs)} checked K3 calls")
    for t, (a, b) in enumerate(zip(checked, timed)):
        if not bool(torch.equal(a, b)):
            raise AssertionError(f"generation step {t}: the checked step "
                                 "differs from the run alone")
    with plain_k3():
        plain, _ = generate(params, cfg, clone(prefilled), first, GEN_STEPS,
                            fed=fed)
    e2e = [drift(a, b) for a, b in zip(timed, plain)]
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(timed, plain))
    step_med = statistics.median(step_times)
    res["generate"] = {
        "prompts": GEN_PROMPTS, "context": LM_CONTEXT, "cache_len": GEN_CACHE,
        "steps": GEN_STEPS, "prefill_ms": prefill_ms,
        "step_ms_median": step_med, "step_ms_min": min(step_times),
        "step_ms_max": max(step_times),
        "tokens_per_s": GEN_PROMPTS / step_med * 1e3,
        "k3_int8_launches": gen_launches, "k3_bf16_launches": gen_bf16,
        "k3_vs_plain_max_abs_err_per_call": max(layer_errs),
        "tolerance": BF16_TOL, "planted_faults_failed": 4 * len(layer_errs),
        "logits_max_abs_err_plain_path": max(e2e),
        "logits_max_abs_err_plain_path_first_step": e2e[0],
        "argmax_agreement_plain_path": agree / (GEN_PROMPTS * GEN_STEPS)}
    # one more generation step under torch.profiler, after the host-timed
    # ones: the device's busy time in a tenant step and its idle share
    with torch.inference_mode():
        prof = profile_step(lambda: tf.decode_step(
            params, fed[-1], gen_cache, LM_CONTEXT + GEN_STEPS, cfg))
    if prof["device_busy_ms"] is not None:
        prof["device_idle_share_of_step_ms"] = \
            1 - prof["device_busy_ms"] / step_med
    res["generate"]["step_profile"] = prof
    del gen_cache, prefilled, timed, checked, plain
    torch.cuda.empty_cache()
    # the decode_32k step of (b) once more under torch.profiler, after the
    # host-timed runs of (b) and (c) so that its tracing cannot slow them
    prof = profile_step(lambda: dec.run(params, batch))
    if prof["device_busy_ms"] is not None:   # against the unprofiled step
        prof["device_idle_share_of_step_ms"] = \
            1 - prof["device_busy_ms"] / res["decode_32k"]["step_ms"]
    res["decode_32k"]["step_profile"] = prof

    # (d) the f32 witness: the weights of (a)-(c) in f32, the int8 cache
    # dequantised to f32 by K3's int8 entry.  The decode_32k step of (b),
    # same cache and token, and the generation of (c), same prompts, each
    # held at every step to the same path with K3 replaced by its plain
    # version, and K3 held at each call at the f32 attention tolerance.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.inference_mode():
        params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    f32_calls = []
    with torch.inference_mode():
        with k3_checked(f32_calls):
            got, _ = tf.decode_step(params32, token, cache, S - 1, cfg32)
        with plain_k3():
            plain, _ = tf.decode_step(params32, token, cache, S - 1, cfg32)
    dec_err = check("decode_32k f32 logits against the plain-K3 path", got,
                    plain, F32_PATH_TOL)
    dec_std = float(got.std())
    del batch, cache, got, plain, token
    torch.cuda.empty_cache()
    last, gen_cache, _ = prefill_prompts(params32, cfg32, prompts, dev)
    prefilled = clone(gen_cache)
    first = last.argmax(dim=-1, keepdim=True).to(torch.int32)
    with k3_checked(f32_calls):
        timed, fed = generate(params32, cfg32, gen_cache, first, GEN_STEPS)
    if len(f32_calls) != cfg.n_layers * (1 + GEN_STEPS):
        raise AssertionError(f"{len(f32_calls)} checked K3 calls in f32")
    with plain_k3():
        plain, _ = generate(params32, cfg32, prefilled, first, GEN_STEPS,
                            fed=fed)
    gen_errs = [check(f"generation step {t} f32 logits against the plain-K3 "
                      "path", a, b, F32_PATH_TOL)
                for t, (a, b) in enumerate(zip(timed, plain))]
    res["f32_witness"] = {
        "tolerance": F32_PATH_TOL,
        "k3_vs_plain_max_abs_err_per_call": max(f32_calls),
        "k3_tolerance": ATTN_F32_TOL,
        "planted_faults_failed": 4 * len(f32_calls),
        "decode_32k_logits_max_abs_err": dec_err,
        "decode_32k_logits_std": dec_std,
        "generate_logits_max_abs_err": max(gen_errs),
        "generate_logits_max_abs_err_first_step": gen_errs[0],
        "generate_argmax_agreement": sum(
            int((a.argmax(-1) == b.argmax(-1)).sum())
            for a, b in zip(timed, plain)) / (GEN_PROMPTS * GEN_STEPS)}
    res["peak_gb"] = max(peak_before_gb,
                         torch.cuda.max_memory_allocated() / 1e9)
    del params32, gen_cache, prefilled, timed, plain
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the cluster day (K4)
# ---------------------------------------------------------------------------

FLEET_JOBS = 100_000   # benchmarks/bench_cluster.py's n_jobs
SMOKE_CAP = 20_000     # the bench_cluster --smoke event-core day
FULL_CAP = 200_000     # examples/cluster_day.py --event-core at full scale
FULL_STEPS = 24        # full-width day cut from 96 provisioning intervals
# benchmarks/baselines/BENCH_cluster_smoke.json, event_core.day (a CPU run
# of the reference), printed beside the card's day for the record
BENCH_SMOKE_DAY = {"peak_power_w": 2325.0, "n_queries": 480_000,
                   "p99_ms": {"dlrm-rmc1": 77.83, "dlrm-rmc3": 50.70}}


def fleet_bench_streams(n_jobs: int = FLEET_JOBS, seed: int = 0):
    """The fleet shape of benchmarks/bench_cluster.py (copied, it imports
    the reference): 512 streams, k in {2, 4, 8, 16}, drawn after the
    saturated stream's n_jobs arrival draws."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rng.exponential(1.0, n_jobs)  # the saturated stream's arrivals
    ks = [2, 4, 8, 16]
    n_streams = 512
    per = 2 * n_jobs // n_streams
    streams = []
    for i in range(n_streams):
        kk = ks[i % len(ks)]
        n = int(per * rng.uniform(0.8, 1.2))
        r = rng.exponential(1.0, n).cumsum() * (1.0 / (1.1 * kk))
        d = rng.choice(rng.uniform(0.5, 1.5, 6), n)
        streams.append((r, d, kk, rng.uniform(0.0, 2.0, kk)))
    return streams


def sweep_all(streams):
    """The oracle: ``engine._sweep`` on every stream."""
    from repro_torch.serving.engine import _sweep

    return [_sweep(s[0], s[1], int(s[2]), s[3] if len(s) > 3 else None,
                   return_state=True) for s in streams]


def check_fleet(name, got, want) -> int:
    """Every stream's ends and sorted end state bitwise; returns jobs."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} results for {len(want)} "
                             "streams")
    jobs = 0
    for j, ((e, st), (we, ws)) in enumerate(zip(got, want)):
        if e.dtype != we.dtype or not np.array_equal(e, we):
            raise AssertionError(f"{name}: stream {j} ends differ from "
                                 "_sweep")
        if not np.array_equal(st, ws):
            raise AssertionError(f"{name}: stream {j} end state differs "
                                 "from _sweep")
        jobs += len(e)
    return jobs


def fleet_must_fail(name, got, want) -> None:
    """Planted faults: one end, then one end-state value, moved by one ulp,
    must each fail ``check_fleet``."""
    import numpy as np

    j = max(range(len(got)), key=lambda i: len(got[i][0]))
    for what in ("ends", "state"):
        bad = [(e.copy(), st.copy()) for e, st in got]
        arr = bad[j][0] if what == "ends" else bad[j][1]
        i = len(arr) // 2
        arr[i] = np.nextafter(arr[i], np.inf)
        try:
            check_fleet(f"{name} (planted {what} ulp)", bad, want)
        except AssertionError:
            continue
        raise AssertionError(f"{name}: a one-ulp fault in {what} passed")


def same_tree(name, a, b, path="$") -> None:
    """Recursive bitwise equality of two ``to_dict()`` trees (NaN equals
    NaN, arrays by dtype, shape and value)."""
    import math

    import numpy as np

    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            raise AssertionError(f"{name}: keys differ at {path}")
        for k in a:
            same_tree(name, a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise AssertionError(f"{name}: lengths differ at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(name, x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        if not (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")):
            raise AssertionError(f"{name}: arrays differ at {path}")
    elif isinstance(a, float) and math.isnan(a):
        if not (isinstance(b, float) and math.isnan(b)):
            raise AssertionError(f"{name}: {path} {a} != {b}")
    elif type(a) is not type(b) or a != b:
        raise AssertionError(f"{name}: {path} {a!r} != {b!r}")


@contextlib.contextmanager
def checked_fleet(log: dict):
    """``event_core.fleet_fifo_finish`` held bitwise against ``_sweep`` on
    every stream of every call for the duration; ``ops.fleet_fifo`` timed
    with CUDA events (K4's device time) and the wide groups' packing,
    copies and unpacking on the host clock.  The checks' own time is kept
    apart in ``log["check_s"]``."""
    import torch

    from repro_torch.kernels.fleet_fifo import ops
    from repro_torch.serving import event_core

    finish, run_fleet, launch = (event_core.fleet_fifo_finish,
                                 event_core._run_fleet, ops.fleet_fifo)
    events = []

    def timed_launch(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args)
        end.record()
        events.append((start, end, int((args[2][1:] - args[2][:-1]).max())))
        return out

    def timed_run_fleet(*args):
        t0 = time.perf_counter()
        run_fleet(*args)
        log["wide_host_s"] += time.perf_counter() - t0

    def checked(streams, device="cuda"):
        streams = list(streams)
        t0 = time.perf_counter()
        got = finish(streams, device=device)
        log["finish_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        log["checked_jobs"] += check_fleet(
            f"fleet call {log['calls']}", got, sweep_all(streams))
        log["check_s"] += time.perf_counter() - t0
        log["calls"] += bool(streams)  # as event_core counts fleet_calls
        return got

    log.update(calls=0, checked_jobs=0, check_s=0.0, finish_s=0.0,
               wide_host_s=0.0)
    event_core.fleet_fifo_finish = checked
    event_core._run_fleet = timed_run_fleet
    ops.fleet_fifo = timed_launch
    try:
        yield log
    finally:
        event_core.fleet_fifo_finish = finish
        event_core._run_fleet = run_fleet
        ops.fleet_fifo = launch
        torch.cuda.synchronize()
        ms = [(a.elapsed_time(b), steps) for a, b, steps in events]
        log["k4_device_ms"] = sum(m for m, _ in ms)
        log["k4_steps"] = max((steps for _, steps in ms), default=0)
        # the launch with the longest chain: its time over its steps is the
        # recurrence's time a step
        m, steps = max(ms, key=lambda x: x[1], default=(0.0, 0))
        log["k4_longest_launch_ms"] = m
        log["k4_ns_per_step"] = m * 1e6 / steps if steps else None


def day_line(day) -> dict:
    return {"feasible": bool(day.feasible),
            "all_meet_sla": bool(day.all_meet_sla),
            "peak_power_w": float(day.peak_power_w),
            "workloads": {w: {"n_queries": int(d["n_queries"]),
                              "p99_ms": float(d["p99_ms"]),
                              "n_hedged": int(d["n_hedged"])}
                          for w, d in day.per_workload.items()}}


def phase_cluster(dev, bw: float) -> dict:
    """(a) K4 alone at bench_cluster's fleet shape, (b) the smoke
    event-core day (as it is, then with every k > 1 group wide), each
    bitwise the CPU day, (c) the full-width event-core day."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.fleet_fifo import fleet_fifo_ref
    from repro_torch.kernels.fleet_fifo import ops
    from repro_torch.serving import event_core
    from repro_torch.serving.scenarios import (compile_scenario, full_scale,
                                               get_scenario)

    res: dict = {"phase": "cluster"}
    # (a) K4 alone
    streams = fleet_bench_streams()
    want = sweep_all(streams)
    got = event_core.fleet_fifo_finish(streams, device=dev)
    jobs = check_fleet("fleet bench", got, want)
    fleet_must_fail("fleet bench", got, want)
    # the wide groups' ragged layout, as fleet_fifo_finish packs it
    packed = []
    launch = ops.fleet_fifo
    ops.fleet_fifo = lambda *a: packed.append(a) or launch(*a)
    try:
        event_core.fleet_fifo_finish(streams, device=dev)
    finally:
        ops.fleet_fifo = launch
    args = packed[0]
    ends, state = ops.fleet_fifo(*args)
    p_ends, p_state = fleet_fifo_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(ends, p_ends):
        raise AssertionError("K4 ends differ from its plain version")
    if not torch.equal(state.sort(dim=1).values, p_state.sort(dim=1).values):
        raise AssertionError("K4 end state differs from its plain version")
    ks = args[3]
    lens = np.diff(args[2].cpu().numpy())
    # the kernel alone: the thread layout made once, as a launch sees it
    lanes = torch.from_numpy(ops.warp_lanes(ks)).to(dev)
    kernel_args = (args[0], args[1], args[2], lanes, args[4])
    state_bytes = 2 * 8 * sum(ks)
    n_bytes = 24 * jobs + state_bytes
    reps = 5
    fin_s = sw_s = float("inf")
    for _ in range(reps):  # interleaved best-of-5, as bench_cluster's pair
        t0 = time.perf_counter()
        event_core.fleet_fifo_finish(streams, device=dev)
        fin_s = min(fin_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        sweep_all(streams)
        sw_s = min(sw_s, time.perf_counter() - t0)
    res["a_fleet_bench"] = {
        "shape": f"{len(streams)} streams, k in {{2, 4, 8, 16}}, {jobs} jobs",
        "tolerance": "bitwise (ends and sorted end state, every stream, "
                     "against _sweep and the plain version)",
        "planted_faults_failed": 2,
        "ms": time_ms(lambda: ops.launch(*kernel_args)),
        "wrapper_ms": time_ms(lambda: ops.fleet_fifo(*args)),
        "plain_ms": time_ms(lambda: fleet_fifo_ref(*args), reps=5),
        "fleet_fifo_finish_ms": fin_s * 1e3,
        "sweep_ms": sw_s * 1e3,
        "bound_ms": n_bytes / bw * 1e3, "bound_by": "bytes",
        "bytes": n_bytes, "chain_steps": int(lens.max()),
        "library_ms": None, "max_abs_err": 0.0}

    # (b) the smoke event-core day
    spec = dataclasses.replace(
        get_scenario("baseline_day"),
        runtime={"event_core": True, "event_core_queries": SMOKE_CAP})
    t0 = time.perf_counter()
    comp = compile_scenario(spec)
    res["b_compile_s"] = time.perf_counter() - t0
    saved_width = event_core._MIN_FLEET_WIDTH
    try:
        for label, width in (("as_is", saved_width), ("width_1", 1)):
            event_core._MIN_FLEET_WIDTH = width
            log: dict = {}
            ops.launches = 0
            event_core.stats_reset()
            t0 = time.perf_counter()
            with checked_fleet(log):
                day = comp.run(device=dev)
            wall = time.perf_counter() - t0
            launches = ops.launches
            stats = dict(event_core.stats)
            if label == "as_is" and launches != 0:
                raise AssertionError(f"smoke day: {launches} K4 launches "
                                     "where no group is wide")
            if label == "width_1" and launches == 0:
                raise AssertionError("smoke day at width 1: K4 never ran")
            t0 = time.perf_counter()
            cpu_day = comp.run(device="cpu")
            cpu_s = time.perf_counter() - t0
            same_tree(f"smoke day {label}", day.to_dict(), cpu_day.to_dict())
            res[f"b_smoke_day_{label}"] = {
                "min_fleet_width": width, "k4_launches": launches,
                "day_s": wall - log["check_s"], "cpu_day_s": cpu_s,
                "equals_cpu_day": True, "fleet": {
                    k: stats[k] for k in ("fleet_calls", "fleet_groups",
                                          "fleet_jobs", "fleet_kernel",
                                          "fleet_seq")},
                "checked_calls": log["calls"],
                "checked_jobs": log["checked_jobs"],
                **day_line(day)}
    finally:
        event_core._MIN_FLEET_WIDTH = saved_width
    res["b_bench_smoke_reference_cpu"] = BENCH_SMOKE_DAY

    # (c) full width: all six workloads x all eleven server types
    full = full_scale(get_scenario("baseline_day"), n_steps=FULL_STEPS)
    t0 = time.perf_counter()
    bridged = compile_scenario(full)
    compile_s = time.perf_counter() - t0
    power = {p: bridged.run(policy=p, device=dev).peak_power_w
             for p in ("hercules", "greedy")}
    comp = compile_scenario(dataclasses.replace(
        full, runtime={"event_core": True, "event_core_queries": FULL_CAP}))
    log = {}
    ops.launches = 0
    event_core.stats_reset()
    t0 = time.perf_counter()
    with checked_fleet(log):
        day = comp.run(device=dev)
    wall = time.perf_counter() - t0
    launches = ops.launches
    stats = dict(event_core.stats)
    if launches == 0:
        raise AssertionError("full-width day: K4 never ran")
    if not day.feasible:
        raise AssertionError("full-width day is infeasible")
    if not all(np.isfinite(d["p99_ms"]) for d in day.per_workload.values()):
        raise AssertionError("full-width day: a non-finite p99")
    res["c_full_width_day"] = {
        "cut": f"{FULL_STEPS} provisioning intervals instead of 96; all "
               f"{len(bridged.table.workloads)} workloads x "
               f"{len(bridged.table.servers)} server types",
        "event_core_queries": FULL_CAP,
        "compile_s": compile_s,
        "day_s": wall - log["check_s"], "check_s": log["check_s"],
        "k4_launches": launches, "k4_device_ms": log["k4_device_ms"],
        "k4_longest_chain": log["k4_steps"],
        "k4_longest_launch_ms": log["k4_longest_launch_ms"],
        "k4_ns_per_step": log["k4_ns_per_step"],
        "wide_groups_host_s": log["wide_host_s"],
        "fleet_fifo_finish_s": log["finish_s"],
        "fleet": {k: stats[k] for k in ("fleet_calls", "fleet_groups",
                                        "fleet_jobs", "fleet_kernel",
                                        "fleet_seq")},
        "checked_calls": log["calls"], "checked_jobs": log["checked_jobs"],
        "bridged_peak_power_w": power,
        "hercules_vs_greedy_peak_power_saving":
            1.0 - power["hercules"] / power["greedy"],
        **day_line(day)}
    res["k4_launches"] = launches
    return res


def kernel_entries(k1: dict, serve_line: dict, k2: dict, k3: dict,
                   lm: dict, cluster: dict) -> list[dict]:
    """The summary of every kernel: where it replaces a TPU kernel, its
    launches on the paths driven here, its error and its times."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import variant

    m = k1["rmc1"]
    i8 = k3["int8"]
    fb = cluster["a_fleet_bench"]
    decode_src = "src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu"
    k1_keys = ("ms", "ms_cold_l2", "ms_cold_clean", "ms_stream", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "cold_share_of_bound",
               "max_abs_err")
    return [{
        "name": "hot_embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:43",
        "launches": serve_line["k1_launches"],
        "launches_note": "the serving path calls the per-feature entry "
                         "(ops.embedding_bag_features), one launch a fused "
                         "batch; the 2-D entry is the same kernel",
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"], "ms_cold_l2": m["ms_cold_l2"],
        "ms_cold_clean": m["ms_cold_clean"], "ms_stream": m["ms_stream"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "cold_share_of_bound": m["cold_share_of_bound"],
        "library_ms": m["library_ms"],
        "features_entry_ms": k1["features"]["ms"],
        "shape": f"table {m['table'][0]}x{m['table'][1]} f32, "
                 f"{m['bags']} bags x P={m['P']}",
        "tolerance": m["tolerance"],
        "other_shapes": {
            name: {"shape": f"table {c['table'][0]}x{c['table'][1]} "
                            f"{c['dtype']}, {c['bags']} bags x P={c['P']}",
                   **{k: c[k] for k in k1_keys}}
            for name, c in (("rm2_full_bf16", k1["rm2"]),
                            ("rmc3_prod", k1["rmc3"]))},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:76",
        "launches": 0,
        "launches_note": "no model path calls K2: the reference's prefill "
                         "uses _attention_chunked; K2 is reached only "
                         "through ops.flash_attention",
        "variant": variant(torch.bfloat16, HEAD_DIM),
        "redesigned_in": 14,
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
        "shape": k2["shape"], "tolerance": k2["tolerance"],
        "prefill_32k": k2["prefill_32k"],
    }, {
        "name": "flash_decode",
        "route": "cuda",
        "source": decode_src,
        "replaces": "src/repro/kernels/flash_attention/flash_decode.py:76",
        "launches": lm["generate"]["k3_bf16_launches"],
        "launches_note": "the llama3.2-3b path keeps an int8 cache, so it "
                         "calls K3's int8 entry (next entry); this bf16 "
                         "entry is reached through ops.flash_decode",
        "redesigned_in": 14,
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
        "shape": k3["shape"], "tolerance": k3["tolerance"],
    }, {
        "name": "flash_decode_int8",
        "route": "cuda",
        "source": decode_src,
        "replaces": "src/repro/kernels/flash_attention/flash_decode.py:76 "
                    "(with the dequantisation around it, "
                    "src/repro/models/transformer.py:175)",
        "launches": lm["generate"]["k3_int8_launches"],
        "launches_note": f"the {GEN_STEPS} generation steps alone, counted "
                         "from 0; the decode_32k step alone launched "
                         f"{lm['decode_32k']['k3_int8_launches']}",
        "redesigned_in": 14,
        "before_ms": i8["eager_dequant_then_k3_ms"],
        "before_of": "the path before this entry, timed in this run: the "
                     "eager dequantisation of one layer, then the bf16 entry",
        "max_abs_err": i8["max_abs_err"], "ms": i8["ms"],
        "plain_ms": i8["plain_ms"], "bound_ms": i8["bound_ms"],
        "bound_by": i8["bound_by"], "library_ms": i8["library_ms"],
        "library_note": i8["library_note"],
        "shape": i8["shape"], "tolerance": i8["tolerance"],
    }, {
        "name": "fleet_fifo",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fleet_fifo/csrc/fleet_fifo.cu",
        "replaces": "src/repro/serving/event_core.py:198 (not Pallas: the "
                    "jitted lax.scan fleet solver, driven by "
                    "fleet_fifo_finish :240)",
        "launches": cluster["k4_launches"],
        "launches_note": "the full-width event-core day of the cluster "
                         "phase, counted from 0",
        "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "library_note": "no PyTorch call computes the k-server FIFO "
                        "recurrence",
        "fleet_fifo_finish_ms": fb["fleet_fifo_finish_ms"],
        "sweep_ms": fb["sweep_ms"], "chain_steps": fb["chain_steps"],
        "shape": fb["shape"], "tolerance": fb["tolerance"],
    }]


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
    from repro_torch.configs.paper_models import rmc1, rmc3

    dev = torch.device("cuda")
    # 3. kernel
    k1 = phase_kernel(dev, bw, f32_rate, rmc1(True), dlrm_rm2.FULL,
                      rmc3(True))

    # 4. serve (the DLRM path; the K1 count is reset inside, just before it)
    serve_line = phase_serve(dev, rmc1(True))
    emit(serve_line)

    # 5-6. the attention kernels alone
    k3 = phase_decode_kernel(dev, bw)
    emit(k3)
    k2 = phase_attention_kernel(dev, bw)
    emit(k2)

    # 7. the LM path (K3's count is reset inside, just before each cell)
    lm = phase_lm(dev)
    emit(lm)

    # 8. the cluster day (K4's count is reset inside, just before each day)
    cluster = phase_cluster(dev, bw)
    emit(cluster)

    emit({"kernels": kernel_entries(k1, serve_line, k2, k3, lm, cluster),
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
