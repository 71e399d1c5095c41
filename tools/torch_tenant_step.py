#!/usr/bin/env python3
"""The LM tenant's decode step of the PyTorch/CUDA port on one NVIDIA GPU.

llama3.2-3b FULL in bf16 with the int8 KV cache (random weights from a
seed): GEN_PROMPTS prompts of LM_CONTEXT tokens prefilled into a
GEN_CACHE-row cache, then greedy decode steps, as ``chip_smoke.py`` phase
lm (c) runs them.  Prints one JSON line:

  - ``step_ms``: each step's host milliseconds from an idle device to the
    device's end of it, their median, min and max;
  - ``profile``: one more step under torch.profiler (device busy ms, idle
    share against the median step, the device events by time);
  - ``ab``, where the tree has K3's int8 entry: the same steps again,
    each run twice in turn, through the int8 entry and through the eager
    dequantisation of the cache followed by the bf16 entry (the path
    before the int8 entry, put back for the run), host ms of each, so
    that the two paths meet the same host load;
  - ``k3``: kernel K3 at the tenant's attention shape, device ms: the bf16
    entry on the cache dequantised eagerly (dequantisation included, the
    path of a tree without the int8 entry) and, where the tree has it, the
    int8 entry; with the split plan the tree takes there;
  - with ``--sweep``, K3's device ms over split plans (``TARGET_BLOCKS`` x
    ``MIN_SPLIT``) at the tenant's shape and at the decode_32k shape, both
    entries.

    python3 tools/torch_tenant_step.py [--src DIR] [--steps N] [--sweep]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees of the port can be timed in
one run on one card.  The timing helpers are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the launcher module (the package's name flash_decode is the wrapper)
LAUNCHER = "repro_torch.kernels.flash_attention.flash_decode"
SWEEP_TARGETS = (512, 1024, 2048)
SWEEP_MIN_SPLITS = (64, 128, 256, 512)


def k3_times(dev, B, S, kv_len, smoke, g) -> dict:
    """K3's device ms at q [B, 1, 24, 128] against an int8 cache
    [B, S, 8, 128] with scales in [0.005, 0.02], at ``kv_len``."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    fd = importlib.import_module(LAUNCHER)
    H, KVH, hd = smoke.HEADS, smoke.KV_HEADS, smoke.HEAD_DIM
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(
        torch.bfloat16) * smoke.PEAK
    kq, vq = (torch.randint(-127, 128, (B, S, KVH, hd), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.empty((B, S, KVH, 1), device=dev).uniform_(
        0.005, 0.02, generator=g) for _ in range(2))
    split_len, n_splits = fd.split_plan(kv_len, B * KVH)
    res = {"shape": f"q [{B}, 1, {H}, {hd}] bf16, k/v [{B}, {S}, {KVH}, "
                    f"{hd}] int8, kv_len {kv_len}",
           "target_blocks": fd.TARGET_BLOCKS, "min_split": fd.MIN_SPLIT,
           "split_len": split_len, "n_splits": n_splits,
           "eager_dequant_then_k3_ms": smoke.time_ms(lambda: ops.flash_decode(
               q, kq.to(q.dtype) * ks.to(q.dtype),
               vq.to(q.dtype) * vs.to(q.dtype), kv_len=kv_len))}
    kd, vd = kq.to(q.dtype) * ks.to(q.dtype), vq.to(q.dtype) * vs.to(q.dtype)
    res["bf16_entry_ms"] = smoke.time_ms(
        lambda: ops.flash_decode(q, kd, vd, kv_len=kv_len))
    int8 = getattr(ops, "flash_decode_int8", None)
    if int8 is not None:
        want = ref.flash_decode_int8_ref(q, kq, ks, vq, vs, kv_len=kv_len)
        res["int8_max_abs_err"] = smoke.check(
            "k3 int8", int8(q, kq, ks, vq, vs, kv_len=kv_len), want,
            smoke.BF16_TOL)
        res["int8_entry_ms"] = smoke.time_ms(
            lambda: int8(q, kq, ks, vq, vs, kv_len=kv_len))
    return res


def interleaved(params, cfg, cache, fed) -> dict:
    """Host ms of each step of ``fed`` through the int8 entry and through
    the eager dequantisation + bf16 entry, in turn (which goes first
    alternates).  Both write the same cache rows: the int8 entry is
    bitwise equal to the bf16 entry on the dequantised cache."""
    import time

    import torch

    from repro_torch.configs.paper_models import LM_CONTEXT
    from repro_torch.dist import decode
    from repro_torch.models import transformer as tf

    def eager(q, kq, ks, vq, vs, *, kv_len, bk=512):
        return decode.decode_attention(q, kq.to(q.dtype) * ks.to(q.dtype),
                                       vq.to(q.dtype) * vs.to(q.dtype),
                                       kv_len=kv_len, bk=bk)

    entry = tf.decode_attention_int8
    times = {"int8_entry": [], "eager_dequant": []}
    try:
        with torch.inference_mode():
            for t, tok in enumerate(fed):
                order = [("int8_entry", entry), ("eager_dequant", eager)]
                for name, fn in order if t % 2 == 0 else order[::-1]:
                    tf.decode_attention_int8 = fn
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tf.decode_step(params, tok, cache, LM_CONTEXT + t, cfg)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        tf.decode_attention_int8 = entry
    a, b = times["int8_entry"], times["eager_dequant"]
    return {"steps": len(fed), "int8_entry_ms": a, "eager_dequant_ms": b,
            "int8_entry_ms_median": statistics.median(a),
            "eager_dequant_ms_median": statistics.median(b),
            "int8_entry_faster_in": sum(x < y for x, y in zip(a, b))}


def sweep(dev, B, S, kv_len, smoke, g) -> list[dict]:
    """``k3_times`` without the eager path, over the split plans."""
    fd = importlib.import_module(LAUNCHER)
    saved = fd.TARGET_BLOCKS, fd.MIN_SPLIT
    rows = []
    try:
        for fd.TARGET_BLOCKS, fd.MIN_SPLIT in itertools.product(
                SWEEP_TARGETS, SWEEP_MIN_SPLITS):
            r = k3_times(dev, B, S, kv_len, smoke, g)
            r.pop("eager_dequant_then_k3_ms")
            r["blocks"] = B * smoke.KV_HEADS * r["n_splits"]
            rows.append(r)
    finally:
        fd.TARGET_BLOCKS, fd.MIN_SPLIT = saved
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_tenant_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.configs.paper_models import LM_CONTEXT
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as tf

    _build.load("flash_decode")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    cell = build_cell(smoke.LM_ARCH, "decode_32k", dev, batch=smoke.GEN_PROMPTS)
    cfg = cell.cfg
    params = cell.init_state(g)
    prompts = torch.randint(0, cfg.vocab, (smoke.GEN_PROMPTS, LM_CONTEXT),
                            generator=g, device=dev, dtype=torch.int32)
    last, cache, prefill_ms = smoke.prefill_prompts(params, cfg, prompts, dev)
    first = last.argmax(dim=-1, keepdim=True).to(torch.int32)
    times = []
    _, fed = smoke.generate(params, cfg, cache, first, args.steps, times=times)
    med = statistics.median(times)
    with torch.inference_mode():
        prof = smoke.profile_step(lambda: tf.decode_step(
            params, fed[-1], cache, LM_CONTEXT + args.steps, cfg), top=12)
    if prof["device_busy_ms"] is not None:
        prof["device_idle_share_of_step_ms"] = 1 - prof["device_busy_ms"] / med
    ab = interleaved(params, cfg, cache, fed) \
        if hasattr(tf, "decode_attention_int8") else None
    del params, cache
    torch.cuda.empty_cache()

    kv_len = LM_CONTEXT + args.steps
    out = {"src": str(args.src), "card": smoke.nvidia_smi(),
           "prompts": smoke.GEN_PROMPTS, "context": LM_CONTEXT,
           "cache_len": smoke.GEN_CACHE, "steps": args.steps,
           "prefill_ms": prefill_ms, "step_ms": times,
           "step_ms_median": med, "step_ms_min": min(times),
           "step_ms_max": max(times), "profile": prof, "ab": ab,
           "k3": k3_times(dev, smoke.GEN_PROMPTS, smoke.GEN_CACHE, kv_len,
                          smoke, g)}
    if args.sweep:
        out["sweep_tenant"] = sweep(dev, smoke.GEN_PROMPTS, smoke.GEN_CACHE,
                                    kv_len, smoke, g)
        out["sweep_decode_32k"] = sweep(dev, smoke.DECODE_BATCH,
                                        smoke.LONG_SEQ, smoke.LONG_SEQ,
                                        smoke, g)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
