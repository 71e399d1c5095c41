#!/usr/bin/env python3
"""Kernel K4 (the fleet FIFO solver) of the PyTorch/CUDA port on one NVIDIA GPU.

For the tree whose ``src`` is given (default: this checkout's), builds K4
alone with nvcc and prints one JSON line:

  - ``ptxas``: registers, stack frame and spill bytes of every kernel in the
    build (``-Xptxas -v``);
  - ``sass``: for every kernel, its ``LDL``/``STL`` instructions (count,
    width and the frame offsets they touch: which array lives in local
    memory) and the instructions of each innermost loop that holds a
    ``DADD`` (the step loop: instructions over adds is the instructions a
    step) (``cuobjdump -sass``);
  - ``a``: K4 at ``chip_smoke.fleet_bench_streams`` (benchmarks/
    bench_cluster.py's fleet shape: 512 streams, k in {2, 4, 8, 16}), and
    ``day``: K4 at ``chip_smoke.k4_day_streams`` (8 streams of 150,000
    jobs at k = 17, a full-width day's longest chain).  Each in two thread
    layouts: ``packed`` (the tree's own ``warp_lanes``, as
    ``fleet_fifo_finish`` packs the streams) and ``one_lane`` (one stream a
    warp), each checked bitwise against ``engine._sweep`` and timed with
    ``chip_smoke.time_ms``; ms, ns a step (ms over the longest chain), the
    byte bound (24 B a job plus the states at the card's memory rate) and,
    where the source has the probes below, the step floor;
  - ``fleet_fifo_finish_ms`` at (a): ``event_core.fleet_fifo_finish`` on
    the host clock, best of 5 (packing, copies, the launch, unpacking).

For a source that keeps its rows in ``RegRow<K>`` (the redesign), the
build is of a copy with probes appended (under the git-ignored
``build/k4_bench/``): a kernel of each register instance alone
(``k4_probe<K>``, ``k4_probe_generic``: per-instance ptxas and SASS) and
``k4_floor<K>``, which runs the step loop of one busy lane over one chunk
of jobs already in shared memory, many times over; its time over its steps
is the instance's ``floor_ns_per_step``, and the step floor of a launch is
the largest of its streams' lengths times their instance's floor.

    python3 tools/k4_bench.py [--src DIR] [--out PATH]
    python3 tools/k4_bench.py --ab PARENT_SRC   # parent, change, change, parent
    python3 tools/k4_bench.py --variants        # patched copies, timed

``k4_floor`` also runs the first kernel's argmin-tree step (``TreeRow<K>``
in the probes) for ``tree_floor_ns_per_step``: the two steps side by side.
``--variants`` writes one patched copy of this checkout's source per entry
of ``VARIANTS`` (chunk length, stages, the step loop's unroll, or the
copies in or the stores out dropped, to time what they cost) under
``build/k4_bench/variants/``, builds them at once, and checks (all but the
"drop" ones) and times each at (a) and the day shape; the shipped source
carries one setting.

``--ab`` runs the tool on PARENT_SRC and on this checkout's ``src`` in turn,
each in its own process, on one card, and writes every line to ``--out``
(default ``build/k4_bench.json``, git-ignored).  The timing helpers are
``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import ctypes
from collections import Counter
import hashlib
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "build" / "k4_bench"
PROBE_MARK = "struct RegRow"
FLOOR_REPS = 250          # chunk passes a floor launch makes
SASS_DUMP = ("probe K=17", "floor sorted K=17", "probe K=4",
             "floor sorted K=4")
OPCODE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)([^;]*);")
BRA_TARGET = re.compile(r"0x([0-9a-f]+)")
LOCAL_OFFSET = re.compile(r"\[R\d+(?:\+(0x[0-9a-f]+|\d+))?\]")

# Appended to a copy of csrc/fleet_fifo.cu (names from that source).
PROBES = r"""
namespace {

template <int K>
__global__ void __launch_bounds__(2 * kLanes, 1) k4_probe(const Args a) {
  const Block b = setup(a);
  if (threadIdx.x >= kLanes)
    produce(a, b);
  else
    consume<RegRow<K>>(a, b);
}

__global__ void __launch_bounds__(2 * kLanes, 1)
    k4_probe_generic(const Args a) {
  const Block b = setup(a);
  if (threadIdx.x >= kLanes)
    produce(a, b);
  else
    consume<MemRow>(a, b);
}

// The first kernel's step, for comparison: an argmin tree over K unsorted
// slots (the lower slot wins a tie), then a select on every slot.
template <int K>
struct TreeRow {
  double w[K];
  int am;

  __device__ __forceinline__ void init(const double* f0) {
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = f0[j];
  }

  __device__ __forceinline__ double front() {
    double v[K];
    int ix[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = w[j];
      ix[j] = j;
    }
#pragma unroll
    for (int span = 1; span < K; span *= 2) {
#pragma unroll
      for (int j = 0; j + span < K; j += 2 * span) {
        const bool right = v[j + span] < v[j];
        v[j] = right ? v[j + span] : v[j];
        ix[j] = right ? ix[j + span] : ix[j];
      }
    }
    am = ix[0];
    return v[0];
  }

  __device__ __forceinline__ void replace_front(double e) {
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = j == am ? e : w[j];
  }
};

// One busy lane: the kernel's step loop over `todo` jobs of a chunk in
// shared memory (a whole chunk takes the loop whose count ptxas knows, as
// in the kernel), `reps` times (each pass reads the ends the last one
// wrote: the same work).
template <class Row>
__global__ void __launch_bounds__(kLanes)
    k4_floor(const double* r_in, const double* d_in, double* out, int todo,
             int reps) {
  __shared__ double r[kPitch], d[kPitch];  // steps() reads one ahead
  for (int j = threadIdx.x; j < kChunk; j += kLanes) {
    r[j] = r_in[j];
    d[j] = d_in[j];
  }
  __syncwarp();
  if (threadIdx.x != 0) return;
  Row w;
  w.init(d_in);
  for (int i = 0; i < reps; ++i) steps_chunk(w, r, d, todo);
  out[0] = w.front();
}

template <int K>
struct Probes {
  static void touch() {
    (void)&k4_probe<K>;
    Probes<K - 1>::touch();
  }
  static cudaError_t floor(int k, int tree, const double* r, const double* d,
                           double* out, int todo, int reps, cudaStream_t s) {
    if (k != K)
      return Probes<K - 1>::floor(k, tree, r, d, out, todo, reps, s);
    if (tree)
      k4_floor<TreeRow<K>><<<1, kLanes, 0, s>>>(r, d, out, todo, reps);
    else
      k4_floor<RegRow<K>><<<1, kLanes, 0, s>>>(r, d, out, todo, reps);
    return cudaGetLastError();
  }
};
template <>
struct Probes<0> {
  static void touch() { (void)&k4_probe_generic; }
  static cudaError_t floor(int, int, const double*, const double*, double*,
                           int, int, cudaStream_t) {
    return cudaErrorInvalidValue;
  }
};

}  // namespace

extern "C" int repro_fleet_fifo_floor(int k, int tree, const void* r,
                                      const void* d, void* out, int todo,
                                      int reps, void* stream) {
  Probes<kMaxReg>::touch();
  return static_cast<int>(Probes<kMaxReg>::floor(
      k, tree, static_cast<const double*>(r), static_cast<const double*>(d),
      static_cast<double*>(out), todo > kChunk ? kChunk : todo, reps,
      static_cast<cudaStream_t>(stream)));
}
"""


def kernel_name(mangled: str) -> str:
    m = re.search(r"k4_probeILi(\d+)E", mangled)
    if m:
        return f"probe K={m.group(1)}"
    m = re.search(r"k4_floorIN\S*?(RegRow|TreeRow)ILi(\d+)E", mangled)
    if m:
        return f"floor {'sorted' if m.group(1) == 'RegRow' else 'tree'} " \
               f"K={m.group(2)}"
    if "k4_probe_generic" in mangled:
        return "probe generic"
    if "fleet_fifo_kernel" in mangled:
        return "kernel"
    return mangled


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers", "stack_frame", "spill_stores", "spill_loads"}}"""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            fn = kernel_name(m.group(1))
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack_frame=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def parse_sass(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """{kernel: [(address, opcode, operands)]} of ``cuobjdump -sass``."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            out[fn] = []
            continue
        m = OPCODE.search(line)
        if fn is not None and m is not None:
            out[fn].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def local_accesses(code) -> dict:
    """LDL/STL counts by opcode, and the frame offsets each width touches."""
    ops: dict[str, int] = {}
    offsets: dict[str, list[int]] = {}
    for _, op, args in code:
        if not op.startswith(("LDL", "STL")):
            continue
        ops[op] = ops.get(op, 0) + 1
        m = LOCAL_OFFSET.search(args)
        off = int(m.group(1), 0) if m and m.group(1) else 0
        width = op.split(".")[1] if "." in op else "32"
        offsets.setdefault(width, []).append(off)
    return {"count": sum(ops.values()), "by_opcode": ops,
            "offset_range_by_width": {w: [min(v), max(v)]
                                      for w, v in offsets.items()}}


def dadd_loops(code) -> list[dict]:
    """Innermost loops (a backward branch and its target) holding a DADD:
    their instructions, DADDs, instructions a DADD (a step), and the count
    of each opcode in them (``DSETP``: k - 1 a step, whichever step;
    ``LDL``/``STL``: local memory)."""
    loops = []
    for addr, op, args in code:
        if not op.startswith("BRA"):
            continue
        m = BRA_TARGET.search(args)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    out = []
    for lo, hi in sorted(set(inner)):
        body = [op for a, op, _ in code if lo <= a <= hi]
        n_dadd = sum(op.startswith("DADD") for op in body)
        if n_dadd:
            out.append({"instructions": len(body), "dadd": n_dadd,
                        "per_step": len(body) / n_dadd,
                        "opcodes": dict(Counter(
                            op.split(".")[0] for op in body).most_common())})
    return out


def sass_summary(lib: Path, cuobjdump: str, dump: Path | None = None
                 ) -> dict:
    """Per kernel: instructions, local memory, step loops; with ``dump``,
    the SASS of the kernels named in ``SASS_DUMP`` written there."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    if dump is not None:
        keep, out = False, []
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                keep = kernel_name(m.group(1)) in SASS_DUMP
            if keep:
                out.append(line)
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(out) + "\n")
    return {fn: {"instructions": len(code), "local": local_accesses(code),
                 "dadd_loops": dadd_loops(code)}
            for fn, code in parse_sass(text).items()}


def compile_k4(src_cu: Path, out: Path) -> subprocess.Popen:
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


def probe_source(src_cu: Path, dest_dir: Path) -> Path:
    """A copy of ``src_cu`` with the probes appended, in ``dest_dir``."""
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / "fleet_fifo_probes.cu"
    dest.write_text(src_cu.read_text() + PROBES)
    return dest


def use_library(lib: Path) -> ctypes.CDLL:
    """Make the tree's K4 wrapper launch the kernel of ``lib``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_fifo import ops

    handle = ctypes.CDLL(str(lib))
    _build._libs["fleet_fifo"] = handle
    ops._fn = None
    return handle


def floor_ns(handle: ctypes.CDLL, ks, dev, time_ms=None,
             tree: bool = False) -> dict[int, float]:
    """ns a step of ``k4_floor`` (one busy lane, jobs in shared memory) for
    each K in ``ks``, with the kernel's sorted step, or with ``tree`` the
    first kernel's argmin tree; timed by ``time_ms``
    (``chip_smoke.time_ms``)."""
    import numpy as np
    import torch

    if time_ms is None:
        import chip_smoke

        time_ms = chip_smoke.time_ms

    fn = handle.repro_fleet_fifo_floor
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chunk = int(re.search(r"constexpr int kChunk = (\d+);",
                          handle_source(handle)).group(1))
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.exponential(0.01, chunk).cumsum()).to(dev)
    d = torch.from_numpy(rng.uniform(0.01, 0.8, chunk)).to(dev)
    out = torch.empty(1, dtype=torch.float64, device=dev)

    def launch(k):
        err = fn(k, int(tree), r.data_ptr(), d.data_ptr(), out.data_ptr(),
                 chunk, FLOOR_REPS, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k4_floor<{k}> launch failed: cuda error "
                               f"{err}")

    res = {}
    for k in ks:
        launch(k)
        torch.cuda.synchronize()
        ms = time_ms(lambda: launch(k), reps=9)
        res[k] = ms * 1e6 / (FLOOR_REPS * chunk)
    return res


def handle_source(handle: ctypes.CDLL) -> str:
    """The CUDA source a probe library was built from (beside it)."""
    return (Path(handle._name).parent / "fleet_fifo_probes.cu").read_text()


def tree_lanes(ops, ks, ns):
    """The tree's own thread layout (its ``warp_lanes`` took ks alone before
    the redesign)."""
    if len(inspect.signature(ops.warp_lanes).parameters) >= 2:
        return ops.warp_lanes(ks, ns)
    return ops.warp_lanes(ks)


def one_lane(ks):
    """One stream a warp: stream s on lane 32 s, the other lanes empty (with
    the stream's k, so the instance switch stays uniform)."""
    import numpy as np

    S = len(ks)
    lanes = np.full((2, 32 * S), -1, dtype=np.int32)
    lanes[0, ::32] = np.arange(S)
    lanes[1] = np.repeat(np.asarray(ks, dtype=np.int32), 32)
    return lanes


def measure_shape(ops, streams, dev, bw, floor, want=None,
                  layouts=("packed", "one_lane"), check=True) -> dict:
    import numpy as np
    import torch

    import chip_smoke as smoke

    ks = [int(s[2]) for s in streams]
    ns = [len(s[0]) for s in streams]
    kmax = max(ks)
    offsets = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    free0 = np.zeros((len(streams), kmax))
    for j, s in enumerate(streams):
        if s[3] is not None:
            free0[j, :ks[j]] = s[3]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.concatenate([s[0] for s in streams]),
        np.concatenate([s[1] for s in streams]), offsets)]
    free0_t = torch.from_numpy(free0).to(dev)
    want = smoke.sweep_all(streams) if want is None else want
    jobs = int(offsets[-1])
    n_bytes = 24 * jobs + 16 * sum(ks)
    chain = max(ns)
    res = {"streams": len(streams), "k": sorted(set(ks)), "jobs": jobs,
           "chain": chain, "bytes": n_bytes,
           "bound_ms": n_bytes / bw * 1e3, "bound_by": "bytes"}
    for name in layouts:
        lanes = tree_lanes(ops, ks, ns) if name == "packed" else one_lane(ks)
        lanes_t = torch.from_numpy(np.ascontiguousarray(lanes)).to(dev)
        ends, state = ops.launch(*args, lanes_t, free0_t)
        ends, state = ends.cpu().numpy(), state.cpu().numpy()
        for j, (we, ws) in enumerate(want if check else ()):
            if not (np.array_equal(ends[offsets[j]:offsets[j + 1]], we)
                    and np.array_equal(np.sort(state[j, :ks[j]]), ws)):
                raise AssertionError(f"{name}: stream {j} differs from "
                                     "_sweep")
        ms = smoke.time_ms(lambda: ops.launch(*args, lanes_t, free0_t))
        res[name] = {"warps": lanes.shape[1] // 32, "ms": ms,
                     "ns_per_step": ms * 1e6 / chain,
                     "share_of_byte_bound": res["bound_ms"] / ms}
    if floor:
        res["step_floor_ms"] = max(n * floor[k] for n, k in zip(ns, ks)) / 1e6
        res["step_floor_note"] = ("the kernel's own floor, not the card's: "
                                  "each stream's length times its "
                                  "instance's ns a step with one busy lane "
                                  "on jobs in shared memory, the largest")
        for name in layouts:
            res[name]["share_of_step_floor"] = (res["step_floor_ms"]
                                                / res[name]["ms"])
    return res


def run_one(src: Path, sass_dump: Path | None = None) -> dict:
    src = src.resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_fifo import ops
    from repro_torch.serving import event_core

    if not torch.cuda.is_available():
        raise SystemExit("k4_bench: no CUDA device")
    cu = _build.sources()["fleet_fifo"]
    probes = PROBE_MARK in cu.read_text()
    tag = hashlib.sha1(str(src).encode()).hexdigest()[:8]
    work = BENCH_DIR / tag
    lib_src = probe_source(cu, work) if probes else cu
    lib = work / "k4_bench.so"
    t0 = time.perf_counter()
    log = finish(compile_k4(lib_src, lib))
    build_s = time.perf_counter() - t0
    handle = use_library(lib)
    nvcc = Path(_build.nvcc_path())
    dev = torch.device("cuda")
    bw, _, _ = smoke.card_rates(torch.cuda.get_device_name(0))
    out = {"src": str(src), "card": smoke.nvidia_smi(),
           "sms": torch.cuda.get_device_properties(0).multi_processor_count,
           "build_s": build_s, "probes": probes,
           "ptxas": ptxas_summary(log),
           "sass": sass_summary(lib, str(nvcc.parent / "cuobjdump"),
                                sass_dump if probes else None)}
    floor = floor_ns(handle, range(1, 33), dev) if probes else None
    if floor:
        out["floor_ns_per_step"] = floor
        out["tree_floor_ns_per_step"] = floor_ns(handle, range(1, 33), dev,
                                                 tree=True)
    out["a"] = measure_shape(ops, smoke.fleet_bench_streams(), dev, bw, floor)
    out["day"] = measure_shape(ops, smoke.k4_day_streams(), dev, bw, floor)
    streams = smoke.fleet_bench_streams()
    event_core.fleet_fifo_finish(streams, device=dev)
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        event_core.fleet_fifo_finish(streams, device=dev)
        best = min(best, time.perf_counter() - t0)
    out["a"]["fleet_fifo_finish_ms"] = best * 1e3
    return out


VARIANTS = [{}, {"insert": "shared"}, {"kChunk": 64}, {"drop": "copies"},
            {"drop": "stores"}]
UNROLL = "#pragma unroll {}\n  for (int u = 0; u < todo; ++u)"
# what a "drop" variant takes out of the source (its results are wrong, so
# it is timed unchecked: it measures what the dropped part costs)
DROP = {"copies": ("        cp_async_8(r + u, a.ready + lo + u);\n"
                   "        cp_async_8(d + u, a.dur + lo + u);\n", ""),
        "stores": ("      if (u < left) a.ends[lo + u] = r[u];\n",
                   "      (void)r;\n")}
# other ways to write the sorted insertion (RegRow::replace_front's loop),
# the same function: "shared" selects on the slot's own compare first (ptxas
# then computes each compare twice), "flags" makes every compare before any
# select, "mask" packs them in bits
INSERT_LOOP = """    bool lt = true;  // w[j] < e, with the popped slot 0 below everything
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const double above = w[j + 1 < K ? j + 1 : j];
      const bool lt_next = j + 1 < K && above < e;
      const double t = lt_next ? above : e;
      w[j] = lt ? t : w[j];
      lt = lt_next;
    }
"""
INSERT = {
    "shared": INSERT_LOOP.replace(
        "      const double t = lt_next ? above : e;\n"
        "      w[j] = lt ? t : w[j];\n",
        "      w[j] = lt_next ? above : (lt ? e : w[j]);\n"),
    "flags": """    bool c[K + 1];
    c[0] = true;
    c[K] = false;
#pragma unroll
    for (int j = 1; j < K; ++j) c[j] = w[j] < e;
#pragma unroll
    for (int j = 0; j < K; ++j)
      w[j] = c[j + 1] ? w[j + 1 < K ? j + 1 : j] : (c[j] ? e : w[j]);
""",
    "mask": """    unsigned long long m = 1;
#pragma unroll
    for (int j = 1; j < K; ++j)
      m |= static_cast<unsigned long long>(w[j] < e) << j;
#pragma unroll
    for (int j = 0; j < K; ++j)
      w[j] = (m >> (j + 1)) & 1 ? w[j + 1 < K ? j + 1 : j]
                                : ((m >> j) & 1 ? e : w[j]);
""",
}


def variant_source(text: str, setting: dict) -> str:
    """``csrc/fleet_fifo.cu``'s text with ``setting`` applied: a constant
    (``kChunk``, ``kStages``) given its value, the step loop's unroll, a
    part dropped (``DROP``), or the insertion written another way
    (``INSERT``)."""
    for key, value in setting.items():
        if key == "unroll":
            old, new = UNROLL.format(4), UNROLL.format(value)
        elif key == "drop":
            old, new = DROP[value]
        elif key == "insert":
            old, new = INSERT_LOOP, INSERT[value]
        else:
            old = re.search(rf"constexpr int {key} = \d+;", text).group(0)
            new = f"constexpr int {key} = {value};"
        if text.count(old) != 1:
            raise ValueError(f"variant {key}: {old!r} is not in the source "
                             "exactly once")
        text = text.replace(old, new)
    return text


def run_variants() -> list[dict]:
    """Each of ``VARIANTS`` as a patched copy of this checkout's source under
    ``build/k4_bench/variants/``, built at once, then checked bitwise and
    timed at (a) and the day shape in the packed layout."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_fifo import ops

    text = _build.sources()["fleet_fifo"].read_text()
    base = BENCH_DIR / "variants"
    base.mkdir(parents=True, exist_ok=True)
    jobs = []
    for d in VARIANTS:
        stem = "k4_" + ("_".join(f"{k}{v}" for k, v in d.items()) or "default")
        cu = base / f"{stem}.cu"
        cu.write_text(variant_source(text, d))
        jobs.append((d, base / f"{stem}.so", compile_k4(cu, base / f"{stem}.so")))
    logs = [finish(proc) for _, _, proc in jobs]
    dev = torch.device("cuda")
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    bw, _, _ = smoke.card_rates(torch.cuda.get_device_name(0))
    shapes = {"a": smoke.fleet_bench_streams(), "day": smoke.k4_day_streams()}
    wants = {k: smoke.sweep_all(s) for k, s in shapes.items()}
    res = []
    for (d, lib, _), log in zip(jobs, logs):
        use_library(lib)
        loops = sass_summary(lib, cuobjdump)["kernel"]["dadd_loops"]
        row = {"setting": d or "default",
               "card": smoke.nvidia_smi(),
               "ptxas": ptxas_summary(log).get("kernel"),
               # each whole-chunk step loop: instructions and compares a
               # step (k - 1 compares a step is one a slot)
               "steps": sorted((lp["per_step"],
                                lp["opcodes"].get("DSETP", 0) / lp["dadd"])
                               for lp in loops if lp["dadd"] > 1)}
        for name, streams in shapes.items():
            m = measure_shape(ops, streams, dev, bw, None, wants[name],
                              layouts=("packed",), check="drop" not in d)
            row[name] = {"ms": m["packed"]["ms"],
                         "ns_per_step": m["packed"]["ns_per_step"]}
        res.append(row)
        print(json.dumps(row), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k4_bench.json",
                    help="where --ab and --variants write all their lines")
    ap.add_argument("--ab", type=Path, default=None,
                    help="a parent tree's src: run parent, change, change, "
                         "parent")
    ap.add_argument("--sass-dump", type=Path, default=None,
                    help="write the SASS of the kernels in SASS_DUMP here")
    ap.add_argument("--variants", action="store_true",
                    help="time patched copies of this checkout's source")
    args = ap.parse_args()
    if args.variants:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(run_variants(), indent=1))
        return 0
    if args.ab is None:
        print(json.dumps(run_one(args.src, args.sass_dump)), flush=True)
        return 0
    lines = []
    for src in (args.ab, ROOT / "src", ROOT / "src", args.ab):
        proc = subprocess.run([sys.executable, __file__, "--src", str(src)],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))
    for line in lines:
        print(json.dumps({
            "src": line["src"], "card": line["card"],
            **{shape: {"chain": line[shape]["chain"],
                       "bound_ms": line[shape]["bound_ms"],
                       "step_floor_ms": line[shape].get("step_floor_ms"),
                       **{lay: {k: line[shape][lay][k]
                                for k in ("ms", "ns_per_step")}
                          for lay in ("packed", "one_lane")}}
               for shape in ("a", "day")},
            "fleet_fifo_finish_ms": line["a"]["fleet_fifo_finish_ms"],
            "ptxas": line["ptxas"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
