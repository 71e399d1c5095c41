#!/usr/bin/env python3
"""Kernel K1 (the embedding bag) of the PyTorch/CUDA port on one NVIDIA GPU.

For the tree whose ``src`` is given (default: this checkout's), builds K1
alone with nvcc and prints one JSON line:

  - ``ptxas``: registers, spill bytes and shared memory of each K1 instance
    (``-Xptxas -v``), and the blocks of it an SM holds at once, worked out
    from those (compute capability 9.0: 64K registers, 228 KB of shared
    memory, 64 warps, 32 blocks an SM);
  - ``sass``: for each instance, its ``LDG.E.128`` count and the longest run
    of them that ends at an ``FADD`` with no ``FADD`` between
    (``cuobjdump -sass``): the row loads a lane has in flight before its
    first add;
  - ``shapes``: K1 at the dlrm-rmc1 prod launch (f32), on a dlrm-rm2
    FULL-shaped bf16 table and at the dlrm-rmc3 prod launch (f32), each
    checked against its plain version and timed as ``chip_smoke.py`` times
    it (``measure_k1``: warm, cold L2, a stream of 8 distinct launches, the
    plain version, ``F.embedding_bag``, the bound);
  - ``sparse_stage_ms``: ``embedding_bag_local`` at the rmc1 launch, host
    clock from an idle device to the device's end of it (the SparseNet stage
    of a fused launch);
  - ``cells``: K1's per-feature entry at the benchmark cells' own launches
    (``CELL_SHAPES``: rm2 serve_bulk [262144, 26, 64] bf16, MT-WnD's deep
    (f32, D = 32) and wide (D = 1) launches [262144, 26, 1], rm2's
    1,000,000-item retrieval call) on the cells' full tables, ids drawn by
    ``bench/gen.py``'s ``draw_batch`` at the cells' traffic files from one
    seed: ``ms`` (one launch repeated), ``ms_cold_l2`` (100 MB written
    before each), the byte bound (ids, distinct rows, output), the first
    1,024 items against the plain version, the launches counted as
    table-major (None for a tree without the count), and ``digest``, the
    SHA-256 of the output's bytes, so that ``--ab`` shows two trees'
    outputs bitwise equal or not.

With ``--sweep`` (this checkout only) it writes one patched copy of
``csrc/embedding_bag.cu`` per launch setting of ``SWEEP`` under the
git-ignored ``build/k1_sweep/`` (warps a block, lane groups a bag, rows in
flight a group, 16-byte row loads that skip L1), builds them all at once,
and for each holds K1 to its plain version and times it with
``measure_k1`` at the three shapes, its per-feature entry at the rmc1
launch; every setting's line is also written to ``--out``.

    python3 tools/k1_bench.py [--src DIR] [--sweep] [--out PATH]
    python3 tools/k1_bench.py --ab PARENT_SRC   # parent, change, change, parent

``--grad`` times K1's backward instead, at the four shapes of the train
phase: the dlrm-rm2 train launch (bf16, D = 64), dlrm-rmc1 prod (f32, D =
32), wide-deep's deep launch (f32, D = 32, 80 M rows) and its wide one (D
= 1), each with the cells' own ids (seed 21, as ``chip_smoke.py``'s train
phase).  Its line holds ptxas's report of the backward's kernels
(registers, spills, static shared memory, and the blocks an SM holds
worked out from those at kWarps warps a block; the 1,024-thread scan and
the 64 KB of dynamic shared memory of the cp.async sums, 3 blocks an SM,
are not in that count), and for each shape the check against the plain
version on the touched rows (``k1_grad_touched``), ``measure_k1_grad``'s
times (kernel, plain, ``F.embedding_bag``'s autograd, bound, each after
an idle wait and 3 untimed calls, the SM clock read beside the kernel;
the kernel also right after the check, with no wait), the stage times
(CUDA events around each stage; a tree without ``GradLaunch`` has none)
and one call under torch.profiler (device time by kernel, which splits
any tree's call into its kernels).
``--grad --settle`` times the first ``SETTLE_CALLS`` calls at the rm2
launch after its check one by one, each with the SM clock's readings
over it and the device allocations it made: at once, after an idle
wait, and after one call and the wait (``run_settle``).

``--ab`` runs the tool on PARENT_SRC and on this checkout's ``src`` in turn,
each in its own process, on one card, and writes every line to ``--out``
(default ``build/k1_bench.json``, git-ignored).  The timing helpers are
``chip_smoke.py``'s.

    python3 tools/k1_bench.py --grad [--src DIR] [--settle]
    python3 tools/k1_bench.py --grad --ab PARENT_SRC
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# k1_bag_kernel<T, O, kWindow, V, L, C, S, U, kFit[, kByFeature]> mangled
# (O: float, or a back-reference to T)
INSTANCE = re.compile(r"k1_bag_kernelI(f|13__nv_bfloat16)(f|S\d*_)Lb([01])E"
                      r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E"
                      r"(?:Lb([01])E)?")
OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
# warps a block (the name of the constant in older trees too)
WARPS = re.compile(r"constexpr int kWarps(?:PerBlock)? = (\d+);")
# The 16-byte row load of csrc/embedding_bag.cu, and the same load skipping
# L1, for the sweep's "l1" setting.
LDG128 = "const int4 q = __ldg(reinterpret_cast<const int4*>(p));"
LDG128_NO_L1 = """int4 q;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
        : "l"(p));"""
SWEEP = [
    {}, {"kTeam": 1, "kRows": 8}, {"kTeam": 1}, {"kTeam": 2},
    {"kTeam": 2, "kRows": 8}, {"kRows": 2}, {"kRows": 8},
    {"l1": "no_allocate"}, {"kWarps": 2}, {"kWarps": 8},
]


def instance_name(mangled: str) -> str:
    m = INSTANCE.search(mangled)
    if m is None:
        return mangled
    t, o, window, v, l, c, team, u, fit, by_feature = m.groups()
    dt = "f32" if t == "f" else "bf16"
    out = "->f32" if o == "f" and t != "f" else ""
    return (f"{dt}{out}{' window' * (window == '1')} V={v} L={l} C={c} "
            f"S={team} U={u} fit={fit}"
            f"{' by feature' * (by_feature == '1')}")


def blocks_per_sm(registers: int, smem: int, warps: int) -> int:
    """Blocks of ``warps`` warps an SM of compute capability 9.0 holds at
    once, at ``registers`` a thread and ``smem`` static bytes a block."""
    regs_warp = -(-registers * 32 // 256) * 256   # allocated 256 at a time
    by_regs = 65536 // regs_warp // warps
    by_smem = 233472 // (-(-smem // 128) * 128 + 1024)  # 1 KB kept a block
    return min(by_regs, by_smem, 64 // warps, 32)


def ptxas_summary(log: str, warps: int) -> dict:
    """{instance: {"registers", "spill_stores", "spill_loads", "smem",
    "blocks_per_sm"}}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = instance_name(m.group(1))
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            s = out[fn]
            s["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            s["smem"] = int(m.group(1)) if m else 0
            s["blocks_per_sm"] = blocks_per_sm(s["registers"], s["smem"],
                                               warps)
    return out


def sass_summary(lib: Path, cuobjdump: str) -> dict:
    """{instance: {"ldg128", "longest_ldg128_run_before_fadd"}}."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn, run = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = instance_name(m.group(1))
            out[fn] = {"ldg128": 0, "longest_ldg128_run_before_fadd": 0}
            run = 0
            continue
        m = OPCODE.search(line)
        if fn is None or m is None:
            continue
        op = m.group(1)
        if op.startswith("LDG.E.128"):
            out[fn]["ldg128"] += 1
            run += 1
        elif op.startswith("FADD"):
            s = out[fn]
            s["longest_ldg128_run_before_fadd"] = max(
                s["longest_ldg128_run_before_fadd"], run)
            run = 0
    return out


def compile_k1(src_cu: Path, out: Path) -> subprocess.Popen:
    """nvcc of ``src_cu`` with the port's flags into ``out``; returns the
    running process (output: ptxas's report)."""
    from repro_torch.kernels import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
           str(src_cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def use_library(lib: Path) -> None:
    """Make the port's K1 launcher launch the kernel of ``lib``: it loads
    its library through ``_build.load``, which returns a loaded one first."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import embedding_bag as launcher

    _build._libs["embedding_bag"] = ctypes.CDLL(str(lib))
    launcher._fn = None


def residency(ptxas: dict, table, ids, warps: int, sms: int) -> dict | None:
    """The K1 instance a launch on ``table``/``ids`` takes where its rows are
    16-byte vectors and one lane group wide (its team of S groups a bag read
    from the instance's name), and the blocks it needs at one bag a team
    beside those the card holds at once (the grid is the smaller)."""
    esize = table.element_size()
    lanes = table.shape[1] * esize // 16
    if table.shape[1] * esize % 16 or lanes not in (1, 2, 4, 8, 16, 32):
        return None
    dt = "f32" if esize == 4 else "bf16"
    name = next((k for k in ptxas
                 if k.startswith(f"{dt} V={16 // esize} L={lanes} C=1 ")
                 and k.endswith("fit=1")), None)
    if name is None:
        return None
    team = int(re.search(r" S=(\d+)", name).group(1))
    per_block = warps * (32 // (lanes * team))   # bags a block holds at once
    need = -(-ids.shape[0] // per_block)
    resident = ptxas[name]["blocks_per_sm"] * sms
    return {"instance": name, "blocks_per_sm": ptxas[name]["blocks_per_sm"],
            "resident_blocks": resident, "blocks_one_bag_a_team": need,
            "grid": min(need, resident)}


def shape_cases(dev):
    """(name, table, ids [bags, P], ids [B, F, P], cfg, tolerance) of the
    three launch shapes, the tables made on ``dev`` from one seed."""
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import dlrm_rm2
    from repro_torch.configs.paper_models import rmc1, rmc3

    g = torch.Generator(dev).manual_seed(7)
    for name, cfg, dtype, seed, tol in (
            ("rmc1_prod", rmc1(True), torch.float32, 3, smoke.F32_TOL),
            ("rm2_full_bf16", dlrm_rm2.FULL, torch.bfloat16, 4,
             smoke.BF16_TOL),
            ("rmc3_prod", rmc3(True), torch.float32, 5, smoke.F32_TOL)):
        emb = cfg.embedding
        ids3_np = smoke.click_launches(cfg, [seed])[0]
        ids = torch.from_numpy(smoke.shifted_ids(ids3_np, emb.row_offsets)
                               ).to(dev)
        yield (name, smoke.k1_table(dev, emb, dtype, g), ids,
               torch.from_numpy(ids3_np).to(dev), cfg, tol)


# (name, configuration file, traffic file, table): the cells' K1 launches;
# "wide" is MT-WnD's dim-1 wide table, pooled from the deep launch's ids
CELL_SHAPES = (
    ("rm2_serve_bulk", "dlrm-rm2", "bulk", "deep"),
    ("rm2_retrieval", "dlrm-rm2", "retrieval", "deep"),
    ("mtwnd_deep", "mt-wnd", "bulk", "deep"),
    ("mtwnd_wide", "mt-wnd", "bulk", "wide"),
)
CELL_SEED = 7
CHECK_ITEMS = 1024


def cell_embedding(sizes: dict, table: str):
    """The port's EmbeddingConfig of a benchmark configuration file's
    sizes (as the benchmark builds it), dim 1 for MT-WnD's wide table."""
    from bench.harness import port_config
    from repro_torch.models.widedeep import _wide_cfg

    cfg = port_config(sizes)
    return _wide_cfg(cfg) if table == "wide" else cfg.embedding


def output_digest(out) -> str:
    """SHA-256 of a tensor's bytes on the host."""
    import hashlib

    import torch

    raw = out.contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.data).hexdigest()


def distinct_rows(ids, offsets, total_rows: int) -> int:
    """Rows of the combined table that the launch's live ids read."""
    import torch

    seen = torch.zeros(total_rows, dtype=torch.bool, device=ids.device)
    for f in range(ids.shape[1]):
        col = ids[:, f]
        seen[col[col >= 0].long() + offsets[f]] = True
    return int(seen.sum())


def measure_cell(name: str, table, ids, emb, scrub, bw: float) -> dict:
    """One line of ``cells``: K1's per-feature entry on ``table``/``ids``
    (the cell's embedding config ``emb``) checked, digested and timed."""
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.embedding import routed_offsets

    off = routed_offsets(emb, table.device)

    def launch():
        return ops.embedding_bag_features(table, ids, off)

    counted = getattr(ops, "table_major_launches", None)
    with torch.inference_mode():
        out = launch()
        torch.cuda.synchronize()
        if counted is not None:
            counted = ops.table_major_launches - counted
        want = ref.embedding_bag_features_ref(table, ids[:CHECK_ITEMS], off)
        tol = smoke.F32_TOL if emb.dtype == torch.float32 else smoke.BF16_TOL
        err = smoke.check(name, out[:CHECK_ITEMS], want, tol)
        digest = output_digest(out)
        del out, want
        ms = smoke.time_ms(launch)
        cold = smoke.time_ms(launch, before=scrub.zero_)
    esize = table.element_size()
    n_bytes = (distinct_rows(ids, emb.row_offsets, emb.total_rows)
               * emb.dim * esize + ids.numel() * 4
               + ids.shape[0] * ids.shape[1] * emb.dim * esize)
    bound = n_bytes / bw * 1e3
    print(json.dumps({"cell": name, "ms": ms, "digest": digest[:16]}),
          file=sys.stderr, flush=True)
    return {"ids": list(ids.shape), "table": list(table.shape),
            "dtype": str(table.dtype).replace("torch.", ""),
            "live_slots": int((ids >= 0).sum()), "max_abs_err": err,
            "table_major_launches": counted, "ms": ms, "ms_cold_l2": cold,
            "bound_ms": bound, "roofline_pct": 100 * bound / ms,
            "digest": digest}


def measure_cells(dev, bw: float) -> dict:
    """``cells`` (see above): each table made once from a seeded generator
    and each launch's ids drawn once, on ``dev``; a table or ids freed
    before the next is made (MT-WnD's deep table is 66.6 GB)."""
    import torch

    import chip_smoke as smoke
    from bench import gen

    scrub = torch.empty(100 * 2**20 // 4, device=dev)
    res, held = {}, {}
    for name, config, traffic, which in CELL_SHAPES:
        sizes = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                           .read_text())
        tr = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json")
                        .read_text())
        emb = cell_embedding(sizes, which)
        if held.get("ids_key") != (config, traffic):
            held.pop("ids", None)
        if held.get("table_key") != (config, which):
            held.pop("table", None)
            torch.cuda.empty_cache()
            g = torch.Generator(dev).manual_seed(CELL_SEED)
            held["table"] = smoke.k1_table(dev, emb, emb.dtype, g)
            held["table_key"] = (config, which)
        if "ids" not in held:
            torch.cuda.empty_cache()
            g = gen.generator(gen.subseed(CELL_SEED, 2, 0), dev)
            held["ids"] = gen.draw_batch(sizes, tr, tr["batch"], g,
                                         dev)["sparse_ids"]
            held["ids_key"] = (config, traffic)
        res[name] = measure_cell(name, held["table"], held["ids"], emb,
                                 scrub, bw)
    held.clear()
    torch.cuda.empty_cache()
    return res


def run_one(src: Path) -> dict:
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.embedding import embedding_bag_local

    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: no CUDA device")
    # K1 alone, compiled here for ptxas's report and the SASS, and launched
    k1_src = _build.sources()["embedding_bag"]
    lib = _build.BUILD_DIR / "k1_bench.so"
    log = finish(compile_k1(k1_src, lib))
    use_library(lib)
    warps = int(WARPS.search(k1_src.read_text()).group(1))
    nvcc = Path(_build.nvcc_path())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"src": str(src), "card": smoke.nvidia_smi(), "sms": sms,
           "ptxas": ptxas_summary(log, warps),
           "sass": sass_summary(lib, str(nvcc.parent / "cuobjdump"))}
    bw, f32_rate, _ = smoke.card_rates(torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    shapes = {}
    for name, table, ids, ids3, cfg, tol in shape_cases(dev):
        err = smoke.check(name, ops.hot_embedding_bag(table, ids),
                          ref.hot_embedding_bag_ref(table, ids), tol)
        shapes[name] = {"table": list(table.shape), "bags": ids.shape[0],
                        "P": ids.shape[1], "max_abs_err": err,
                        **smoke.measure_k1(table, ids, bw, f32_rate,
                                           smoke.k1_stream(cfg, dev)),
                        "residency": residency(out["ptxas"], table, ids,
                                               warps, sms)}
        if name == "rmc1_prod":
            with torch.inference_mode():
                out["sparse_stage_ms"] = smoke.host_ms(
                    lambda: embedding_bag_local({"table": table}, ids3,
                                                cfg.embedding))
        del table, ids, ids3
        torch.cuda.empty_cache()
    out["shapes"] = shapes
    out["cells"] = measure_cells(dev, bw)
    return out


GRAD_NAME = re.compile(r"(k1g?_[a-z_]+?)I(f|13__nv_bfloat16|4int4)((?:Li\d+E)*)E")


def grad_instance(mangled: str) -> str:
    m = GRAD_NAME.search(mangled)
    if m is None:
        m = re.search(r"k1g?_[a-z_]+", mangled)
        return m.group(0) if m else mangled
    name, t, ints = m.groups()
    args = [{"f": "f32", "13__nv_bfloat16": "bf16", "4int4": "int4"}[t]]
    args += re.findall(r"\d+", ints)
    return f"{name}<{','.join(args)}>"


def grad_ptxas(log: str, warps: int) -> dict:
    """ptxas's report of the backward's kernels, by instance name."""
    out = {}
    for k, v in ptxas_summary(log, warps).items():
        out[grad_instance(k)] = v
    return out


def grad_cases(dev):
    """(name, ids [B, F, P] on ``dev``, embedding config, seed) of K1's
    backward at the train phase's four shapes."""
    import torch

    import chip_smoke as smoke
    from repro_torch.configs.paper_models import rmc1
    from repro_torch.data.clicklog import cell_batch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.widedeep import _wide_cfg

    def cell_ids(arch_id):
        cell = build_cell(arch_id, "train_batch", dev)
        ids = cell_batch(cell.cfg, cell.batch_specs, seed=21)["sparse_ids"]
        return cell.cfg, torch.from_numpy(ids).to(dev)

    cfg, ids = cell_ids("dlrm-rm2")
    yield "rm2_train_launch", ids, cfg.embedding, 5
    del ids
    cfg = rmc1(True)
    yield ("rmc1_prod", torch.from_numpy(smoke.click_launches(cfg, [3])[0])
           .to(dev), cfg.embedding, 6)
    cfg, ids = cell_ids("wide-deep")
    yield "wide_deep_deep", ids, cfg.embedding, 7
    yield "wide_deep_wide", ids, _wide_cfg(cfg), 6


def run_grad(src: Path) -> dict:
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import embedding_bag as launcher
    from repro_torch.kernels.embedding_bag import ops

    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: no CUDA device")
    srcs = {k: v for k, v in _build.sources().items()
            if k.startswith("embedding_bag_grad")}
    procs = {k: compile_k1(v, _build.BUILD_DIR / f"k1_bench_{k}.so")
             for k, v in srcs.items()}
    ptxas = {}
    for k, proc in procs.items():
        warps = int(WARPS.search(srcs[k].read_text()).group(1))
        ptxas.update(grad_ptxas(finish(proc), warps))
    out = {"src": str(src), "card": smoke.nvidia_smi(), "ptxas": ptxas,
           "design": "radix" if hasattr(launcher, "GradLaunch") else
                     "torch.sort"}
    bw, f32_rate, _ = smoke.card_rates(torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    cases = {}
    for name, ids3, emb, seed in grad_cases(dev):
        line, g, off = smoke.k1_grad_touched(dev, name, ids3, emb, seed)
        H = emb.total_rows
        line.update(smoke.measure_k1_grad(g, ids3, off, H, bw, f32_rate))
        if out["design"] == "radix":
            line["stages"] = smoke.k1_grad_stages(g, ids3, off, H)
        line["profile"] = smoke.profile_step(
            lambda: ops.embedding_bag_features_grad(g, ids3, off, H),
            top=24)
        cases[name] = line
        print(json.dumps({"case": name, "ms": line["ms"],
                          "stages": line.get("stages")}), file=sys.stderr,
              flush=True)
        del g, ids3
        torch.cuda.empty_cache()
    out["cases"] = cases
    return out


SETTLE_CALLS = 30
SETTLE_IDLE_S = 2.0


def settle_calls(fn, n: int) -> list[dict]:
    """``n`` calls of ``fn`` one by one, each timed alone (CUDA events, the
    spin ahead), with the SM clock's [min, median, max] over it and the
    device allocations the caching allocator made in it."""
    import torch

    import chip_smoke as smoke

    calls = []
    with smoke.SmClock() as clock:
        for _ in range(n):
            allocs = torch.cuda.memory_stats().get("num_device_alloc")
            torch.cuda._sleep(smoke.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            clock.t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            clock.t1 = time.perf_counter()
            after = torch.cuda.memory_stats().get("num_device_alloc")
            calls.append({"ms": start.elapsed_time(end),
                          "sm_mhz": clock.window(),
                          "device_allocs": None if allocs is None
                          else after - allocs})
    return calls


def run_settle(src: Path) -> dict:
    """K1's backward at the rm2 train launch right after its check, as
    ``measure_k1_grad`` meets it, in three rounds, each after the check
    anew: its first SETTLE_CALLS calls at once (``after_check``); the same
    after SETTLE_IDLE_S seconds of an idle card (``after_idle``); one
    call, then the idle wait, then the calls (``after_call_and_idle``)."""
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels.embedding_bag import ops

    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: no CUDA device")
    dev = torch.device("cuda")
    name, ids3, emb, seed = next(grad_cases(dev))
    H = emb.total_rows
    out = {"src": str(src), "card": smoke.nvidia_smi(), "case": name}
    for round_ in ("after_check", "after_idle", "after_call_and_idle"):
        _, g, off = smoke.k1_grad_touched(dev, name, ids3, emb, seed)

        def entry():
            ops.embedding_bag_features_grad(g, ids3, off, H)

        if round_ == "after_call_and_idle":
            entry()
        if round_ != "after_check":
            torch.cuda.synchronize()
            time.sleep(SETTLE_IDLE_S)
        out[round_] = settle_calls(entry, SETTLE_CALLS)
        del g
    return out


def variant_source(text: str, setting: dict) -> str:
    """``csrc/embedding_bag.cu``'s text with ``setting`` applied: each
    ``kWarps``/``kTeam``/``kRows`` given its value, ``l1: no_allocate``
    turning the 16-byte row load into one that skips L1."""
    for key, value in setting.items():
        if key == "l1":
            old, new = LDG128, LDG128_NO_L1
        else:
            old = re.search(rf"constexpr int {key} = \d+;", text).group(0)
            new = f"constexpr int {key} = {value};"
        if text.count(old) != 1:
            raise ValueError(f"sweep setting {key}: {old!r} is not in the "
                             "source exactly once")
        text = text.replace(old, new)
    return text


def run_sweep() -> list[dict]:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.embedding import routed_offsets

    text = _build.sources()["embedding_bag"].read_text()
    base = ROOT / "build" / "k1_sweep"
    base.mkdir(parents=True, exist_ok=True)
    jobs = []
    for d in SWEEP:
        stem = "k1_" + ("_".join(f"{k}{v}" for k, v in d.items()) or "default")
        cu = base / f"{stem}.cu"
        cu.write_text(variant_source(text, d))
        lib = base / f"{stem}.so"
        jobs.append((d, lib, compile_k1(cu, lib),
                     int(WARPS.search(cu.read_text()).group(1))))
    logs = [finish(proc) for _, _, proc, _ in jobs]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bw, f32_rate, _ = smoke.card_rates(torch.cuda.get_device_name(0))
    cases = list(shape_cases(dev))
    streams = {c[0]: smoke.k1_stream(c[4], dev) for c in cases}
    res = []
    for (d, lib, _, warps), log in zip(jobs, logs):
        use_library(lib)
        ptxas = ptxas_summary(log, warps)
        row = {"setting": d or "default", "ptxas": {
            k: v for k, v in ptxas.items()
            if k.startswith(("f32 V=4 L=8 ", "bf16 V=8 L=8 "))}}
        _, table, _, ids3, cfg, _ = cases[0]
        offsets = routed_offsets(cfg.embedding, dev)
        got3 = ops.embedding_bag_features(table, ids3, offsets)
        flat = torch.from_numpy(smoke.shifted_ids(
            ids3.cpu().numpy(), cfg.embedding.row_offsets)).to(dev)
        row["rmc1_features_equal_2d"] = bool(torch.equal(
            got3.reshape(-1, table.shape[1]),
            ops.hot_embedding_bag(table, flat)))
        row["rmc1_features_ms"] = smoke.time_ms(
            lambda: ops.embedding_bag_features(table, ids3, offsets))
        for name, table, ids, _, _, tol in cases:
            try:
                err = smoke.check(name, ops.hot_embedding_bag(table, ids),
                                  ref.hot_embedding_bag_ref(table, ids), tol)
            except AssertionError as e:  # a wrong setting is reported
                row[name] = {"error": str(e)}
                continue
            row[name] = {"max_abs_err": err,
                         "residency": residency(ptxas, table, ids, warps, sms),
                         **smoke.measure_k1(table, ids, bw, f32_rate,
                                            streams[name])}
        res.append(row)
        print(json.dumps(row), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--grad", action="store_true",
                    help="time K1's backward (see above)")
    ap.add_argument("--settle", action="store_true",
                    help="with --grad: its first calls one by one")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_bench.json",
                    help="where --ab and --sweep write all their lines")
    ap.add_argument("--ab", type=Path, default=None,
                    help="a parent tree's src: run parent, change, change, "
                         "parent")
    args = ap.parse_args()
    if args.sweep:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(run_sweep(), indent=1))
        return 0
    one = (run_settle if args.settle else run_grad) if args.grad else run_one
    if args.ab is None:
        print(json.dumps(one(args.src)), flush=True)
        return 0
    lines = []
    for src in (args.ab, ROOT / "src", ROOT / "src", args.ab):
        proc = subprocess.run([sys.executable, __file__, "--src", str(src)]
                              + ["--grad"] * args.grad,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))
    if args.grad:
        for line in lines:
            print(json.dumps({"src": line["src"], "card": line["card"],
                              **{n: {"ms": c["ms"], "bound_ms": c["bound_ms"],
                                     "ms_first": c["ms_first"],
                                     "stages": c.get("stages")}
                                 for n, c in line["cases"].items()}}))
        return 0
    keys = ("ms", "ms_cold_l2", "ms_cold_clean", "ms_stream", "library_ms",
            "bound_ms")
    cell_keys = ("ms", "ms_cold_l2", "bound_ms", "table_major_launches",
                 "digest")
    for line in lines:
        print(json.dumps({"src": line["src"], "card": line["card"],
                          "sparse_stage_ms": line["sparse_stage_ms"],
                          **{n: {k: c[k] for k in keys}
                             for n, c in line["shapes"].items()},
                          **{n: {k: c[k] for k in cell_keys}
                             for n, c in line["cells"].items()}}))
    digests = {n: {line["cells"][n]["digest"] for line in lines}
               for n in lines[0]["cells"]}
    print(json.dumps({"outputs_bitwise_equal": {
        n: len(d) == 1 for n, d in digests.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
