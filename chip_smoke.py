#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  0. analysis - ``repro_torch.analysis`` (the port's static analysis) over
               the package, this script and the port's tests: files,
               findings and suppressions by rule; any finding fails the run;
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
  8. lm_configs, lm_train - (a) decode_32k of qwen2-7b (batch 64, cut
               from 128), deepseek-67b (32 of its 95 layers, batch 8),
               qwen2-moe-a2.7b (batch 8) and olmoe-1b-7b (batch 16) at FULL
               width, random weights and a random int8 cache: K3's int8
               entry at KV groups 7, 8, 1 and 1, n_layers launches a step
               counted from 0, the step again with K3 held to its plain
               version at every call (in blocks of 8 batch rows), step ms,
               peak; then K3's int8 entry alone on the first layer's cache
               beside its plain version and byte bound; (b) llama3.2-3b
               train_4k at FULL width (bf16, chunked attention, remat,
               AdamW), batch 4 (cut from 256), S = 4096: 3 steps on one
               TokenStream batch, the loss falling from about ln(128256)
               + 3072 x 0.02^2 / 2 (a 0.02-std init),
               step, grad and update ms, peak, tokens/s and the model-FLOP
               rate against 989 TFLOP/s, one gradient pass under
               torch.profiler (device time by kernel); a 2-layer
               FULL-width f32 copy's loss and every gradient held to the
               CPU at 1e-4 of the leaf's largest entry;
  9. recsys  - the rest of Hercules' paper models and the registry's
               recsys cells (``repro_torch.launch.serve_recsys``,
               ``repro_torch.launch.steps``), random weights from a seed:
               (a) mt-wnd prod (26 x 20,000,000 x 32 deep and a dim-1 wide
               table, 68.6 GB, ``torch.cuda.mem_get_info`` printed first)
               served behind its T7 schedule for 40 queries, two K1 launches
               a fused launch (counted from 0), one kept launch's [d, 5]
               logits against the same model with K1's plain version, the
               launch's stages, and K1 alone at the deep (D = 32) and the
               wide (D = 1) launch as in the kernel phase; (b) din and (c)
               dien prod (an 84.6 MB QR table, 200-step history) served the
               same way, no K1 launch, one kept launch against the model's
               CPU copy (DIEN at ``DIEN_TOL``), every logit finite, the item
               ids shown to reach past the QR feature's 74,692 stored rows,
               the launch's host time and DIEN's two recurrences' share of
               it; (d) serve_p99 of wide-deep, din, mind and dlrm-rm2 FULL
               and retrieval_cand of din (in chunks) and mind at 1,000,000
               candidates: time, peak memory, K1 launches, each held to K1's
               plain version where it reaches K1, else to a CPU copy (a
               retrieval on 4 blocks of candidates); last, one din and one
               dien launch under torch.profiler (device busy, idle share,
               device events);
  10. train  - training through ``repro_torch.launch.steps``' train cells
               (random weights from a seed, 3 steps on one fixed batch, the
               loss at each step and after them, falling): (a) the recsys
               train_batch cells of dlrm-rm2 (16.64 GB bf16 table), wide-deep,
               din and mind at FULL width, B = 65,536, rowwise AdaGrad, K1's
               forward and backward launches counted from 0 (one a K1 table
               a pass); (b) GraphSAGE's four train cells at FULL width (AdamW):
               ogb_products on a 2,449,029-node synthetic graph (one layer's
               aggregate held to the CPU on the in-edges of 65,536 nodes,
               every gradient finite), minibatch_lg (1,024 seeds sampled at
               fanout 15-10 from a 232,965-node graph at 32 edges a node,
               cut from the shape's 492; the graph's and the
               sampler's host seconds), full_graph_sm and molecule (each's
               gradients held to a CPU copy at 1e-4); (c) K1's backward
               against its plain version at the dlrm-rm2 train launch and
               at wide-deep's deep launch (f32, D = 32, an 80,000,000-row
               table past 2^31 elements) on the rows each touches, every
               other row exactly zero, two launches bitwise equal; at
               dlrm-rmc1 prod and at wide-deep's wide (D = 1) launch on the
               whole dense gradient; timed beside its plain version, the
               autograd of ``F.embedding_bag`` and its byte bound (the
               pooled gradient and the ids read once, the dense gradient
               written once); (d) each recsys model's gradients on the card against a
               CPU copy at vocabularies cut to 3,000 rows, then one AdaGrad
               step on each from the same gradients; each check with planted
               faults; step ms, peak memory, parameter and optimizer GB;
               then ``repro_torch.launch.train_dlrm`` (dlrm-100m, batch
               1024): its first step held to its plain versions (K1's
               per-feature entry on the step's table and ids, K1's
               backward on them against the whole dense plain gradient,
               each timed beside its plain version, library call and
               bound; the step's gradients and AdaGrad update against a
               CPU copy, planted faults failing each check), then the
               checkpointing Trainer in a temporary
               directory: run A 60 steps with a commit every 20, run B
               crashed before step 45 and resumed after step 40, ending on
               A's loss and state (1e-6; bitwise reported), the step-60
               commit restored bitwise, K1 and its backward launched once
               a step;
 11. dist    - the distributed layer (``repro_torch.dist``, ``launch.mesh``)
               on 2 rank processes sharing the card over gloo (NCCL refuses
               two ranks on one device, so every collective crosses the
               host: none of its times is a multi-card NCCL time).  The
               single-device references run first in this process, each
               freed before the next: (a) dlrm-rm2 FULL's serve_p99 cell
               (batch 512) with its bf16 table (130,000,384 x 64, 16.64 GB)
               row-sharded over (data 1, model 2): each rank builds only
               its 65,000,192 rows (drawn in chunks, each from its own
               seed: bitwise those rows of the whole table), K1's row
               window held to its plain version (planted faults: the
               neighbouring shard's rows, a dropped id) and timed beside
               its plain version, ``F.embedding_bag`` and its byte bound,
               the f32 partial's all-reduce, the sharded pool against the
               single-device K1 within one bf16 ulp of its largest value,
               the logits at the bf16 tolerance and, fed the single-device
               pool, at 1e-4; (b) llama3.2-3b FULL's long_500k (B 1, S
               524,288, a random int8 cache of 31 GB) sequence-sharded over
               ("data", "model") and tensor-parallel over "model": a rank
               holds 262,144 rows of every kv head and its block of the
               weights; one step with K3's int8 partials (28 a rank, all 24
               heads) and the collectives counted from 0 (a layer: the
               packed head gather, the partials' merge, two all-reduces),
               again with every partials call held to its plain version
               (planted faults: the next row's scales, a wrong kv_offset),
               the new token's K/V row on exactly one rank and no other row
               moved, its vocabulary slice of the logits, parameter GB and
               peak, K3's partials and the all-gather timed, then the step
               in f32 (FULL) against one device's at 1e-3; (c) the
               olmoe MoE layer (FULL, f32, 4,096 tokens, experts split
               32/32), the vocab-parallel loss on logits [2, 4096, 128256]
               split in halves, GraphSAGE full_graph_sm (edges over both
               ranks) and molecule (graphs over a (2, 1) mesh), each
               against its single-device function (f32 1e-5, 2e-4 for sums
               of reordered partials); (d) one rank over NCCL: (a)'s
               dataflow at train_dlrm's table (3.2 M x 32 f32) bitwise one
               device's, and the int8 decode's merge;
 12. dist_train - the train and prefill cells on a mesh (``build_cell(...,
               mesh=)``), 2 rank processes sharing the card over gloo as in
               ``dist``, the single-device references first (each freed
               before the next, handed to the ranks through files): (a)
               dlrm-rm2 FULL train_batch (batch 65,536) with its bf16 table
               row-sharded over (data 1, model 2): 2 steps with every call
               of K1's window backward held to its plain version on the
               window's touched rows, every other row exactly 0 (planted
               fault: the window off by one row), launches and collectives
               counted from 0, one more step timed, the window backward
               timed alone beside its plain version, the library's
               autograd and its byte bound; then a copy with every
               vocabulary cut to 3,000 rows (every width kept) on the mesh
               against one device: loss, DenseNet gradients, the rank's
               table-gradient rows and its rows after one AdaGrad step;
               (b) llama3.2-3b FULL width train_4k, 4 layers, B 2, S 4096,
               tensor-parallel over "model": the loss and each rank's block
               of every gradient leaf against one device in bf16 (3e-2 x
               the leaf's largest entry), step and peak a rank; (c) olmoe-1b-7b FULL width train_4k, 2 layers, B 1,
               experts and heads over "model", the same check in f32; (d)
               llama3.2-3b prefill_32k, 2 layers, B 1: each rank's
               vocabulary slice of the last logits and its kv_heads of the
               int8 cache against one device, in an f32 copy (logits at
               1e-3, codes at most one apart; the bf16 cell is timed);
               (e)
               GraphSAGE full_graph_sm (edges over both ranks) and molecule
               (graphs over a (2, 1) mesh): the f32 cell timed, a float64
               copy's loss and gradients at 1e-5 (in f32 a reordered sum
               can flip a ReLU).  Planted faults
               that must fail: a missing ``collectives.enter`` ((b), (c),
               full_graph_sm), a row-parallel all-reduce left out ((d)), a
               block's own mean for the global one (molecule), the table's
               rows off by one ((a));
 13. dryrun  - (a) ``python -m repro_torch.launch.dryrun --all --mesh
               both`` in a process of its own (a fake world of 256, then
               512 ranks; every cell traced on the meta device), ending 0
               within 120 s with every record's keys, one line a mesh (the
               cells over 80 GB a rank); (b) the dry run's trace of the
               cells the phases above ran, at their cuts (llama3.2-3b
               decode_32k B 16, prefill_32k B 1, train_4k B 4; dlrm-rm2
               train_batch; ogb_products; dist_train's rm2 and llama
               cells and dist's tensor-parallel long_500k on (data 1,
               model 2)): its arguments within 512
               bytes a tensor of what making the state and batch added to
               the caching allocator's requested bytes, and to its
               allocated bytes within that plus 1 MiB a tensor past 1 MiB
               (a large block keeps its segment's rest unsplit up to
               1 MiB); its peak within 10% of a step's measured allocated
               peak above its baseline; (c)
               qwen2-7b train_4k at FULL width, 2 layers, B 1, bf16, on 8
               gloo ranks on the card, (data 1, model 8): 28 heads and 4
               kv heads, each kv head replicated on 2 ranks and its 7 q
               heads padded to 8; the loss and each rank's gradient blocks
               against one device at 3e-2 (a padded head's exactly zero;
               the planted fault of an unsummed kv head must fail), the
               padded heads and their moments exactly zero after the
               step, each kv head's copies and moments bitwise equal;
               then in the same ranks its tensor-parallel decode_32k,
               FULL width, 2 layers, B 16, a random int8 cache of 32,768
               rows (4,096 a rank, every kv head): K3's int8 partials and
               the collectives counted from 0 (2, and 4 all-gathers and 5
               all-reduces, a rank), every partials call against its
               plain version, the gathered logits against one device's
               in f32 at 1e-3 (the slices out of order must fail) and in
               bf16 within 3e-2 of the largest logit;
 14. cluster - kernel K4 (the fleet FIFO solver) and the Hercules cluster
               day through ``repro_torch.serving.scenarios``: (a) K4 at
               benchmarks/bench_cluster.py's fleet shape (512 streams, k in
               {2, 4, 8, 16}, 199,444 jobs) and at a full-width day's
               longest chain (8 streams of 150,000 jobs at k = 17), every
               stream bitwise ``engine._sweep`` and K4's plain version,
               with planted one-ulp faults; timed alone (ns a step, the
               byte bound, and the kernel's step floor: each instance's ns
               a step with one busy lane on jobs already in shared memory,
               from tools/k4_bench.py's probes, built beside the kernels),
               the fleet shape also through ``fleet_fifo_finish`` and
               against the sequential sweep; (b) the smoke event-core
               day (``baseline_day``, cap 20,000), as it is (no wide group:
               no K4 launch) and with ``_MIN_FLEET_WIDTH`` = 1 (every
               call through K4), each bitwise the same day on the CPU and
               every fleet call bitwise ``_sweep``; (c) the full-width
               event-core day (all six workloads x all eleven server
               types, cut from 96 to 24 intervals, cap 200,000) from an
               empty profile cache (its 66 pairs profiled first in 8
               processes at once), every fleet call bitwise ``_sweep``,
               with the bridged days' Hercules-vs-greedy peak power;
 15. entries - the kernel entries no phase above calls by name, each
               against its plain version: K1's 2-D backward
               (``hot_embedding_bag_grad``) at the dlrm-rmc1 production
               launch, in float64, two launches bitwise equal and a planted
               fault; K4's ``fleet_fifo_streams`` and ``fleet_fifo`` at the
               fleet shape of (a), bitwise ``_sweep`` and their CPU calls;
 16. cells   - the registry's cells no phase above builds on the card and
               one card holds (CELL_CUTS), each through ``build_cell(arch,
               shape, "cuda", ...)`` at FULL width, cut only as far as the
               80 GB card forces (the cut the dry run's peak sets:
               CUT_BUDGET), one line each with the dry run's predicted
               peak, against which the step's measured peak is held at
               PEAK_TOL: long_500k of qwen2-7b,
               deepseek-67b (29 of 95 layers), qwen2-moe-a2.7b (21 of 24)
               and olmoe-1b-7b, one step at pos = S - 1 over a random int8
               cache of 524,288 rows, K3's int8 launches counted from 0
               (n_layers), the step again with K3 held to its plain
               version at every call in blocks of CHECK_KV_HEADS kv heads
               (planted faults as in (8), and a decode_32k cell's kv_len),
               the new token's K/V row written at pos and at no other row,
               K3's int8 entry alone on the first layer's cache beside its
               plain version and byte bound; train_4k of deepseek-67b (4
               layers) and qwen2-moe-a2.7b (8), batch 1 (cut from 256):
               3 steps on one TokenStream batch, the loss falling from ln V
               + d x 0.02^2 / 2, then one FULL-width layer in f32 (the
               vocabulary cut to CHECK_VOCAB rows) held to the CPU at 1e-4
               of each leaf's largest entry (the MoE's CPU copy routing
               every token as the card did); serve_bulk of
               wide-deep, din, mind and dlrm-rm2 (262,144 rows) and
               retrieval_cand of wide-deep and dlrm-rm2 (1,000,000
               candidates as one bulk batch; rm2's 1.664e9 id slots, 77%
               of int32's range), their click logs drawn in blocks of
               rows: each held on row blocks (the first, the
               last, one across the 32,768-row chunk boundary and random
               ones) against K1's plain version or a CPU copy, a one-row
               fault failing, each K1 launch timed alone beside
               ``F.embedding_bag`` and its byte bound.
Then the coverage line (every registry cell but NOT_ON_ONE_CARD's built on
the card by this process, in the phase CARD_CELLS or CELL_CUTS names).
Every attention-kernel check is also shown to fail planted faults (zeros,
half the keys, the wrong KV head, the causal mask flipped, and for the int8
entry each row read with the next row's scales); the kernel phases feed
peaked queries so that attention outputs are O(1) against the bf16
tolerance.
Then a line of every phase's seconds, the kernel summary line (K1, K1's backward, K2, K3, K3's int8 entry,
K1's row window, K1's window backward, K3's int8 partials and K4) with the
whole script's
seconds, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits 2 before any phase.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types
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


class SmClock:
    """The card's SM clock in MHz, read through NVML (the library
    nvidia-smi reads) by a thread every ``period_s`` while the ``with``
    block runs.  ``time_ms(..., clock=c)`` marks its timed window;
    ``c.window()`` gives [min, median, max] of the readings inside the
    last window, or None where NVML cannot be loaded."""

    def __init__(self, period_s: float = 0.002):
        self.period_s = period_s
        self.samples: list[tuple[float, int]] = []
        self.t0 = self.t1 = None
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        import ctypes

        import torch

        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return self
        handle, mhz = ctypes.c_void_p(), ctypes.c_uint()
        if nvml.nvmlInit_v2() or nvml.nvmlDeviceGetHandleByIndex_v2(
                torch.cuda.current_device(), ctypes.byref(handle)):
            return self

        def run():
            while not self._stop.is_set():
                if nvml.nvmlDeviceGetClockInfo(handle, 1,  # NVML_CLOCK_SM
                                               ctypes.byref(mhz)) == 0:
                    self.samples.append((time.perf_counter(), mhz.value))
                self._stop.wait(self.period_s)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return False

    def window(self) -> list[int] | None:
        got = sorted(m for t, m in self.samples if self.t0 <= t <= self.t1)
        return [got[0], got[len(got) // 2], got[-1]] if got else None


def time_ms(fn, reps: int = TIMING_REPS, before=None,
            clock: SmClock | None = None) -> float:
    """Median device milliseconds of ``fn()`` on the current stream, after
    warm-up; ``before()`` runs ahead of each timed call, outside the timed
    window.  A spin kernel ahead of the start event keeps the device busy
    while the host enqueues ``fn``, so host launch overhead is not timed.
    ``clock`` (an open ``SmClock``) gets the timed window."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if clock is not None:
        clock.t0 = time.perf_counter()
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
    if clock is not None:
        clock.t1 = time.perf_counter()
    return statistics.median(times)


def host_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median host-clock milliseconds of ``fn()`` from an idle device to the
    device's end of it (for stages that include host work)."""
    import torch

    for _ in range(warmup):
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


def _mem(kind: str):
    import numpy as np
    import torch

    torch.cuda.synchronize()
    st = torch.cuda.memory_stats()
    return np.array([st[f"allocated_bytes.all.{kind}"],
                     st[f"requested_bytes.all.{kind}"]], dtype=np.int64)


def mem():
    """The caching allocator's (allocated, requested) bytes now, once the
    stream is idle: its blocks' sizes, and the bytes the tensors asked
    for."""
    return _mem("current")


def mem_peak():
    """The same two at their peak since ``reset_peak_memory_stats``."""
    return _mem("peak")


def mem_reading(growth, tensors: list, before_step, peak) -> dict:
    """What phase ``dryrun`` (b) holds the dry run's prediction of one cell
    to: what making its state and batch (``tensors``) added to the
    allocated and the requested bytes (``growth``, from ``mem()``), and
    the peak of a step above its baseline (``before_step`` less that
    growth)."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    return {"args_growth_bytes": int(growth[0]),
            "args_requested_bytes": int(growth[1]), "tensors": len(sizes),
            "large_tensors": sum(n > LARGE_REMAINDER for n in sizes),
            "peak_above_baseline_bytes": int(peak[0] - (before_step[0]
                                                        - growth[0])),
            "peak_requested_bytes": int(peak[1] - (before_step[1]
                                                   - growth[1]))}


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


def launch_stages(model, batch_np, dev) -> dict:
    """Where one fused launch's time goes (host clock, idle device between
    the stages): features to the card, the sparse part, the dense part,
    scores back."""
    import torch

    from repro_torch.models.recsys_base import batch_to_tensors

    with torch.inference_mode():
        batch = batch_to_tensors(batch_np, dev)
        pooled = model.apply_sparse(batch)
        logits = model.apply_dense_given_pooled(batch, pooled)
        return {
            "launch_ms": host_ms(
                lambda: model(batch_to_tensors(batch_np, dev)).float().cpu()),
            "h2d_ms": host_ms(lambda: batch_to_tensors(batch_np, dev)),
            "sparse_k1_ms": host_ms(lambda: model.apply_sparse(batch)),
            "dense_ms": host_ms(
                lambda: model.apply_dense_given_pooled(batch, pooled)),
            "d2h_ms": host_ms(lambda: logits.float().cpu()),
        }


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

    stages = launch_stages(model, batch_np, dev)
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


# K3's int8 entry held to its plain version in blocks of this many batch
# rows (each row attends alone), so the plain version's dequantised copy
# of the cache is a block's
CHECK_ROWS = 8


def int8_faults(calls: int, batch: int, kv_blocks: int = 1,
                per_block: int = 4) -> int:
    """The planted faults ``k3_checked`` fails over ``calls`` int8 calls
    at ``batch`` rows: ``k3_int8_controls``' four (``per_block``) a block
    of CHECK_ROWS rows and ``kv_blocks`` blocks of kv heads."""
    return per_block * calls * -(-batch // CHECK_ROWS) * kv_blocks


@contextlib.contextmanager
def k3_checked(errs: list, kv_block: int | None = None,
               wrong_kv_len: int | None = None):
    """K3 as on the path, held at every call to its plain version on the
    same inputs at the bf16 tolerance (the f32 tolerance for f32 q), with
    the planted faults of ``k3_controls`` / ``k3_int8_controls`` failing
    the same check; the kernel's output continues the path.  Each call's
    max abs error goes to ``errs``.  The int8 entry's call is held in
    blocks of CHECK_ROWS batch rows and, with ``kv_block``, of that many
    kv heads (with their q heads: each kv head attends alone), so the
    plain version's dequantised copy is a block's; ``wrong_kv_len``: one
    more planted fault a block, the plain version at that kv_len."""
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
        name = f"K3 int8 call {len(errs)}"
        err = 0.0
        KVH = kq.shape[2]
        kb = KVH if kv_block is None else kv_block
        group = q.shape[2] // KVH
        for b in range(0, q.shape[0], CHECK_ROWS):
            rows = slice(b, b + CHECK_ROWS)
            for h in range(0, KVH, kb):
                heads = slice(h * group, (h + kb) * group)
                args = [q[rows, :, heads]] + [t[rows, :, h:h + kb]
                                              for t in (kq, ks, vq, vs)]
                want = ref.flash_decode_int8_ref(*args, **kw)
                err = max(err, check(name, out[rows, :, heads], want,
                                     tol(q)))
                k3_int8_controls(name, want, *args, tol(q), **kw)
                if wrong_kv_len is not None:
                    must_fail(f"{name}, kv_len {wrong_kv_len}",
                              ref.flash_decode_int8_ref(*args, **{
                                  **kw, "kv_len": wrong_kv_len}),
                              want, tol(q))
                del args, want
        errs.append(err)
        return out

    with swap_k3(both, both_int8):
        yield


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

    from repro_torch.common.tree import tree_map

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
            "device_events": sum(r[2] for r in rows),
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

    from repro_torch.common.tree import tree_leaves, tree_map
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
    m0 = mem()
    params = pre.init_state(g)
    params_growth = mem() - m0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{cfg.param_count()}")
    res = {"phase": "lm", "model": LM_ARCH, "params": n_params,
           "weights_gb": n_params * 2 / 1e9}

    # (a) prefill_32k: batch 1, S = 32768
    m1 = mem()
    tokens = torch.randint(0, cfg.vocab, (pre.batch, pre.seq_len),
                           generator=g, device=dev, dtype=torch.int32)
    growth = params_growth + mem() - m1
    reset_k3(ops)
    times = []
    for _ in range(2):               # the first run warms cuBLAS up
        before = mem()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pre.run(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if len(times) == 1:
            prefill_mem = mem_reading(growth, tree_leaves(params) + [tokens],
                                      before, mem_peak())
    logits = out["logits"]
    if tuple(logits.shape) != (pre.batch, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
    res["prefill_32k"] = {"batch": pre.batch, "seq_len": pre.seq_len,
                          "ms": times[-1], "first_ms": times[0],
                          "logits_finite": True,
                          "k3_launches": k3_count(ops),
                          "memory": prefill_mem}
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
    m1 = mem()
    cache = {name: torch.randint(-127, 128, spec.shape, generator=g,
                                 device=dev, dtype=torch.int8)
             for name, spec in specs.items() if spec.dtype == torch.int8}
    for name in ("ks", "vs"):
        cache[name] = torch.empty(specs[name].shape, device=dev).uniform_(
            0.005, 0.02, generator=g)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev,
                          dtype=torch.int32)
    batch = {"token": token, "cache": cache}
    growth = params_growth + mem() - m1
    before = mem()
    base_gb = torch.cuda.memory_allocated() / 1e9
    peak_before_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_k3(ops)
    got = dec.run(params, batch)["logits"]
    torch.cuda.synchronize()
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_mem = mem_reading(growth, tree_leaves(params) + list(
        cache.values()) + [token], before, mem_peak())
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
        "tolerance": BF16_TOL,
        "planted_faults_failed": int8_faults(len(layer_errs), B),
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
        "memory": decode_mem,
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
        "tolerance": BF16_TOL,
        "planted_faults_failed": int8_faults(len(layer_errs), GEN_PROMPTS),
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
        "planted_faults_failed": int8_faults(cfg.n_layers, B)
        + int8_faults(cfg.n_layers * GEN_STEPS, GEN_PROMPTS),
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
# the other LM families' decode, and LM training
# ---------------------------------------------------------------------------

# decode_32k of the other LM configs at FULL width: (batch, depth) cut
# from 128 sequences (and deepseek-67b's 95 layers) only as far as one
# 80 GB card forces: the bf16 weights and the int8 cache of 32,768 rows a
# sequence (qwen2-7b 15.23 GB + 0.97 GB a sequence; qwen2-moe 30.29 +
# 3.27; olmoe 13.84 + 2.18; deepseek 1.384 GB a layer + 0.069 a layer a
# sequence, so 32 of its 95 layers at batch 8)
LM_DECODE_CUTS = {"qwen2-7b": (64, None), "deepseek-67b": (8, 32),
                  "qwen2-moe-a2.7b": (8, None), "olmoe-1b-7b": (16, None)}
# long_500k: K3's per-call check in blocks of this many kv heads (with
# their q heads), so the plain version's copy of a block, dequantised and
# then widened to f32 (2 + 2 + 4 bytes an element of k and of v, 1.07 GB
# a kv head at 524,288 rows), fits beside the cut's state
CHECK_KV_HEADS = 2
# and its extra planted fault: the step attending a decode_32k cell's rows
LONG_FAULT_KV_LEN = 32768
# llama3.2-3b train_4k: batch cut 256 -> LM_TRAIN_BATCH, the largest power
# of two one card holds (38.55 GB of bf16 weights and gradients and f32
# moments, then ~7 GB a sequence under the remat: 64.9 GB at batch 4 on
# the H100, so batch 8 would need ~93)
LM_TRAIN_BATCH = 4
LM_TRAIN_STEPS = 3
# the FULL-width f32 copy held to the CPU: 2 layers, one sequence of
# LM_CHECK_SEQ tokens in chunks of LM_CHECK_CHUNK (two chunks)
LM_CHECK_SEQ, LM_CHECK_CHUNK = 512, 256
LM_CHECK_TOL = 1e-4


def lm_config_decode(dev, bw: float, arch_id: str,
                     shape: str = "decode_32k", batch_cut: int | None = None,
                     depth: int | None = None) -> dict:
    """One decode step of ``arch_id``'s ``shape`` cell at FULL width on a
    random int8 cache, cut to ``batch_cut`` sequences and ``depth``
    layers (decode_32k: as LM_DECODE_CUTS says): K3's int8 launches
    counted from 0 (n_layers), the step again with K3 held to its plain
    version at every call (bitwise the step alone), step ms and peak;
    then, the weights freed, K3's int8 entry alone on the first layer's
    cache beside its plain version and byte bound.  long_500k (one
    sequence of 524,288 rows) holds K3 in blocks of CHECK_KV_HEADS kv
    heads, adds the planted fault of a decode_32k cell's kv_len, and
    checks that the step wrote the new token's K/V row at pos (each
    (layer, kv head)'s codes reach 127, the int8 quantiser's mark, where
    the random row held other values) and no other row (``slice_sums``)."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.steps import build_cell

    if shape == "decode_32k":
        batch_cut, depth = LM_DECODE_CUTS[arch_id]
    long = shape == "long_500k"
    g = torch.Generator(dev).manual_seed(31)
    torch.cuda.reset_peak_memory_stats()
    dec = build_cell(arch_id, shape, dev, batch=batch_cut, n_layers=depth)
    cfg = dec.cfg
    if not (cfg.decode_impl == "flash" and cfg.kv_quant == "int8"):
        raise AssertionError(f"{arch_id}: unexpected config {cfg}")
    t0 = time.perf_counter()
    params = dec.init_state(g)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{arch_id}: {n_params} parameters, expected "
                             f"{cfg.param_count()}")
    B, S = dec.batch, dec.seq_len
    pos = S - 1
    specs = dec.batch_specs["cache"]
    cache = {name: torch.randint(-127, 128, specs[name].shape, generator=g,
                                 device=dev, dtype=torch.int8)
             for name in ("k", "v")}
    for name in ("ks", "vs"):
        cache[name] = torch.empty(specs[name].shape, device=dev).uniform_(
            0.005, 0.02, generator=g)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev,
                          dtype=torch.int32)
    batch = {"token": token, "cache": cache}
    old_row = {k: v[:, :, pos].clone() for k, v in cache.items()}
    before = slice_sums(cache, pos) if long else None
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_k3(ops)
    got = dec.run(params, batch)["logits"]
    torch.cuda.synchronize()
    launches = ops.launches["flash_decode_int8"]
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers or ops.launches["flash_decode"]:
        raise AssertionError(f"{arch_id}: K3's int8 entry launched "
                             f"{launches} times in a decode step (bf16 entry "
                             f"{ops.launches['flash_decode']}), expected "
                             f"{cfg.n_layers} (and 0)")
    if tuple(got.shape) != (B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{arch_id}: logits {tuple(got.shape)} not "
                             "finite")
    row = None
    if long:
        row = new_row_check(arch_id, cache, old_row, pos, before)
    errs = []
    kv_block = CHECK_KV_HEADS if long else None
    with k3_checked(errs, kv_block=kv_block,
                    wrong_kv_len=LONG_FAULT_KV_LEN if long else None):
        checked = dec.run(params, batch)["logits"]
    if len(errs) != cfg.n_layers or not bool(torch.equal(checked, got)):
        raise AssertionError(f"{arch_id}: {len(errs)} checked K3 calls; the "
                             "checked step differs from the step alone")
    if long and slice_sums(cache, pos) != before:
        raise AssertionError(f"{arch_id}: the checked step moved a cache row "
                             "other than pos")
    step_ms = host_ms(lambda: dec.run(params, batch), reps=5)
    kv_blocks = -(-cfg.n_kv_heads // kv_block) if long else 1
    line = {"arch": arch_id, "shape": shape, "batch": B,
            "batch_cut_from": dec.shape["global_batch"],
            "n_layers": cfg.n_layers,
            "n_layers_cut_from": None if depth is None else
            get_arch(arch_id).FULL.n_layers, "seq_len": S,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "group": cfg.n_heads // cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "moe": cfg.moe is not None, "params": n_params,
            "weights_gb": n_params * 2 / 1e9,
            "cache_gb": sum(t.numel() * t.element_size()
                            for t in cache.values()) / 1e9,
            "setup_s": setup_s, "step_ms": step_ms,
            "k3_int8_launches": launches,
            "k3_vs_plain_max_abs_err_per_call": max(errs),
            "tolerance": BF16_TOL, "check_rows": CHECK_ROWS,
            "check_kv_heads": kv_block,
            "planted_faults_failed": int8_faults(
                len(errs), B, kv_blocks, 5 if long else 4),
            "logits_std": float(got.float().std()),
            "step_peak_gb": step_peak_gb,
            "peak_gb": max(setup_peak, torch.cuda.max_memory_allocated())
            / 1e9}
    if row is not None:
        line["new_row"] = row
    # K3's int8 entry alone on the first layer's cache, kv_len = S (the
    # weights and the other layers freed: the plain version's dequantised
    # copy of the whole layer needs the room)
    layer = [cache[n][0].clone() for n in ("k", "ks", "v", "vs")]
    del params, got, checked, cache, batch, old_row
    torch.cuda.empty_cache()
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(
        torch.bfloat16) * PEAK
    out = ops.flash_decode_int8(q, *layer, kv_len=S)
    err = check(f"{arch_id} k3 int8 alone", out, torch.cat([
        ref.flash_decode_int8_ref(*(t[b:b + CHECK_ROWS] for t in (q, *layer)),
                                  kv_len=S)
        for b in range(0, B, CHECK_ROWS)]), BF16_TOL)
    n_bytes = attn_bytes(q, *layer, out)
    t_bytes = n_bytes / bw * 1e3
    t_ops = 4 * B * H * S * hd / BF16_PEAK * 1e3
    line["k3_int8"] = {
        "shape": f"q [{B}, 1, {H}, {hd}] bf16, k/v [{B}, {S}, {KVH}, {hd}] "
                 f"int8, scales [{B}, {S}, {KVH}, 1] f32, kv_len {S}",
        "max_abs_err": err, "tolerance": BF16_TOL,
        "ms": time_ms(lambda: ops.flash_decode_int8(q, *layer, kv_len=S)),
        "plain_ms": time_ms(lambda: ref.flash_decode_int8_ref(
            q, *layer, kv_len=S), reps=5),
        "library_ms": None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": n_bytes}
    line["k3_int8"]["share_of_bound"] = \
        line["k3_int8"]["bound_ms"] / line["k3_int8"]["ms"]
    del q, layer, out
    torch.cuda.empty_cache()
    return line


def new_row_check(arch_id: str, cache: dict, old_row: dict, pos: int,
                  before: list) -> dict:
    """The decode step wrote row ``pos`` of every layer and leaf and no
    other row: each (layer, sequence, kv head)'s new codes reach 127 in
    magnitude (the int8 quantiser scales a row's largest entry to it) and
    the row differs from the random one it replaced; every other row's
    checksum is unchanged (``slice_sums`` against ``before``)."""
    import torch

    new = {k: v[:, :, pos] for k, v in cache.items()}
    for name in ("k", "v"):
        peak = new[name].abs().amax(dim=-1)
        if not bool((peak == 127).all()):
            raise AssertionError(f"{arch_id}: row {pos} of {name} holds no "
                                 f"quantised row (largest codes "
                                 f"{peak.unique().tolist()[:8]})")
    moved = {k: bool((new[k] != old_row[k]).any(dim=-1).all())
             for k in new}
    if not all(moved.values()):
        raise AssertionError(f"{arch_id}: row {pos} not written everywhere "
                             f"({moved})")
    if slice_sums(cache, pos) != before:
        raise AssertionError(f"{arch_id}: the step moved a cache row other "
                             f"than {pos}")
    return {"pos": pos, "written_at_pos": True, "other_rows_unchanged": True,
            "scale_range": [float(torch.cat([new["ks"], new["vs"]]).min()),
                            float(torch.cat([new["ks"], new["vs"]]).max())]}


def phase_lm_configs(dev, bw: float) -> dict:
    """decode_32k of qwen2-7b, deepseek-67b, qwen2-moe-a2.7b and
    olmoe-1b-7b at FULL width (K3's int8 entry at KV groups 7, 8, 1, 1)."""
    t0 = time.perf_counter()
    res = {"phase": "lm_configs", "cells": {}}
    for arch_id in LM_DECODE_CUTS:
        res["cells"][arch_id] = lm_config_decode(dev, bw, arch_id)
        emit({"phase": "lm_configs", "stage": "decode_32k",
              **res["cells"][arch_id]})
    res["seconds"] = time.perf_counter() - t0
    return res


@contextlib.contextmanager
def recorded_routing(record: list):
    """The MoE router as on the path (``repro_torch.dist.moe``'s
    ``moe_router``), each call's top-k experts (sorted) appended to
    ``record``."""
    from repro_torch.dist import moe

    real = moe.moe_router

    def router(params, x, cfg):
        idx, w, aux = real(params, x, cfg)
        record.append(idx.detach().sort(dim=-1).values.cpu())
        return idx, w, aux

    moe.moe_router = router
    try:
        yield
    finally:
        moe.moe_router = real


def lm_train_check(dev, arch_id: str = LM_ARCH, layers: int = 2,
                   seq: int = LM_CHECK_SEQ, vocab: int | None = None
                   ) -> dict:
    """A ``layers``-layer copy of ``arch_id`` at FULL width in f32 (its
    vocabulary cut to ``vocab`` rows where given, every width kept; for
    llama3.2-3b 2 layers at d 3072, 24/8 heads, d_ff 8192, vocab 128256),
    one TokenStream sequence of ``seq`` tokens (chunked attention in
    LM_CHECK_CHUNK chunks where the config chunks): ``lm_loss`` and every
    gradient leaf on the card (remat on, as the cell) against the CPU
    (remat off: the same function) at LM_CHECK_TOL of the leaf's largest
    entry, a MoE model's CPU copy routing every token to the experts the
    card chose (``recorded_routing``: each layer's top-k on both, the
    remat's recompute the same as the forward); planted faults (zeros,
    the two layers' gradients swapped, a leaf of the same shape's
    gradient) must fail the check."""
    import dataclasses

    import torch

    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as tf

    full = get_arch(arch_id).FULL
    cfg = dataclasses.replace(full, n_layers=layers, dtype=torch.float32,
                              attn_chunk=min(LM_CHECK_CHUNK, seq),
                              vocab=vocab or full.vocab)
    params = tf.init(cfg, generator=torch.Generator(dev).manual_seed(5),
                     device=dev)
    tokens = torch.from_numpy(TokenStream(cfg.vocab, seed=6).batch(
        1, seq)["tokens"])
    out, routing = {}, {"card": [], "cpu": []}
    for where, remat in (("card", True), ("cpu", False)):
        p = tree_map(lambda t: t.detach().to(
            "cpu" if where == "cpu" else dev).requires_grad_(True), params)
        held = contextlib.nullcontext() if cfg.moe is None else \
            recorded_routing(routing[where])
        t0 = time.perf_counter()
        with held:
            loss = tf.lm_loss(p, {"tokens": tokens.to(p["embed"].device)},
                              dataclasses.replace(cfg, remat=remat))
            grads = torch.autograd.grad(loss, tree_leaves(p))
        out[where] = (loss.detach().cpu(), [g.cpu() for g in grads],
                      time.perf_counter() - t0)
        del p, loss, grads
    del params
    torch.cuda.empty_cache()
    (loss, grads, card_s), (want_loss, want, cpu_s) = out["card"], out["cpu"]
    if cfg.moe is not None:
        # the card's forward and the remat's recompute, the CPU's forward
        card, cpu = routing["card"], routing["cpu"]
        if len(card) != 2 * layers or len(cpu) != layers:
            raise AssertionError(f"{arch_id}: {len(card)} router calls on "
                                 f"the card, {len(cpu)} on the CPU, expected "
                                 f"{2 * layers} and {layers}")
        moved = [int((a != b).any(dim=-1).sum())
                 for a, b in zip(card, cpu + cpu)]
        if any(moved):
            raise AssertionError(f"{arch_id}: the tokens routed to other "
                                 f"experts than the CPU's, by call: {moved}")
    errs = [check(f"{arch_id} train check loss", loss, want_loss,
                  LM_CHECK_TOL)]
    faults = 0
    for i, (g, w) in enumerate(zip(grads, want)):
        name = f"{arch_id} train check gradient leaf {i}"
        errs.append(check(name, g, w, LM_CHECK_TOL))
        wrong = {"zeros": torch.zeros_like(w)}
        if w.dim() >= 2 and w.shape[0] == 2:        # a stacked block leaf
            wrong["layers swapped"] = w.flip(0)
        twin = next((j for j, o in enumerate(want)
                     if j != i and o.shape == w.shape), None)
        if twin is not None:
            wrong[f"leaf {twin}'s gradient"] = want[twin]
        for what, bad in wrong.items():
            must_fail(f"{name}, {what}", bad, w, LM_CHECK_TOL)
        faults += len(wrong)
    return {"config": f"{arch_id} FULL width, {layers} layer"
                      f"{'s' if layers > 1 else ''}, f32"
                      + (f", vocabulary cut to {cfg.vocab} rows"
                         if cfg.vocab != full.vocab else ""),
            "batch": 1, "seq_len": seq, "attn_impl": cfg.attn_impl,
            "loss": float(loss), "loss_cpu": float(want_loss),
            "leaves": len(grads), "max_abs_err_relative_to_leaf_max": max(
                e / max(float(w.abs().max()), 1e-30)
                for e, w in zip(errs[1:], want)),
            "tolerance": LM_CHECK_TOL, "planted_faults_failed": faults,
            "routing_tokens_differing": 0 if cfg.moe is not None else None,
            "card_s": card_s, "cpu_s": cpu_s}


def lm_train_steps(dev, arch_id: str, batch: int,
                   n_layers: int | None = None, profile: bool = True
                   ) -> dict:
    """``arch_id``'s train_4k at FULL width (bf16, remat, adamw; cut to
    ``batch`` sequences and ``n_layers`` layers), S = 4096:
    LM_TRAIN_STEPS steps on one TokenStream batch, the loss falling from
    about ln V + d x 0.02^2 / 2; step, grad and update ms, peak memory,
    tokens/s, the model-FLOP rate; with ``profile`` one more gradient
    pass under torch.profiler."""
    import math

    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch_id, "train_4k", dev, batch=batch,
                      n_layers=n_layers)
    cfg = cell.cfg
    if not (cfg.remat and cfg.dtype == torch.bfloat16):
        raise AssertionError(f"unexpected train config {cfg}")
    m0 = mem()
    state = cell.init_state(torch.Generator(dev).manual_seed(3))
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{cfg.param_count()}")
    B, S = cell.batch, cell.seq_len
    tokens = torch.from_numpy(TokenStream(cfg.vocab, seed=0).batch(
        B, S)["tokens"]).to(dev)
    batch = {"tokens": tokens}
    growth = mem() - m0
    state_gb = tree_gb(state["params"]) + tree_gb(state["opt"])
    losses, times = [], []
    before = mem()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, out = cell.run(state, batch)
        losses.append(float(out["loss"]))
        times.append((time.perf_counter() - t) * 1e3)
        if len(times) == 1:
            step_mem = mem_reading(growth, tree_leaves(state) + [tokens],
                                   before, mem_peak())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grads = cell.value_and_grad(state, batch)
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t) * 1e3
    del grads
    # where the gradient pass goes: one more under torch.profiler (device
    # time by kernel)
    prof = profile_step(lambda: cell.value_and_grad(state, batch),
                        top=12) if profile else None
    # from the 0.02-std init, the head's logits have variance d x 0.02^2
    # (the final norm's output has unit RMS), so the first loss is about
    # ln V + d x 0.02^2 / 2 (11.76 + 0.61 at llama3.2-3b's d = 3072)
    ln_v = math.log(cfg.vocab)
    init_loss = ln_v + cfg.d_model * 0.02 ** 2 / 2
    if not (all(math.isfinite(x) for x in losses)
            and all(b < a for a, b in zip(losses, losses[1:]))
            and abs(losses[0] - init_loss) < 0.5):
        raise AssertionError(f"{arch_id} train_4k losses {losses}: not "
                             f"falling, or the first not within 0.5 of ln V "
                             f"+ d x 0.02^2 / 2 = {init_loss}")
    step_ms = statistics.median(times)
    n_active = cfg.active_param_count()    # a MoE's routed top-k only
    flops = 6 * n_active * B * S
    full = get_arch(arch_id).FULL
    res = {"arch": arch_id, "shape": "train_4k",
           "batch": B, "batch_cut_from": cell.shape["global_batch"],
           "n_layers": cfg.n_layers, "n_layers_cut_from":
           None if n_layers is None else full.n_layers,
           "attn_impl": cfg.attn_impl, "moe": cfg.moe is not None,
           "seq_len": S, "params": n_params, "active_params": n_active,
           "state_gb": state_gb,
           "steps": LM_TRAIN_STEPS, "losses": losses,
           "loss_after_steps": float(loss), "ln_vocab": ln_v,
           "init_loss_expected": init_loss,
           "step_ms": times, "median_step_ms": step_ms, "grad_ms": grad_ms,
           "update_ms": step_ms - grad_ms, "peak_gb": peak_gb,
           "memory": step_mem, "grad_profile": prof,
           "tokens_per_s": B * S / step_ms * 1e3,
           "model_flops_per_step": flops,
           "model_flop_rate_share": flops / (step_ms / 1e3) / BF16_PEAK,
           "model_flop_rate_formula": "6 x active params x B x S / step "
                                      "seconds / 989e12 (dense bf16 peak); "
                                      "attention's score and value products "
                                      "and the remat's second forward not "
                                      "counted"}
    del state, batch, tokens, cell, loss
    torch.cuda.empty_cache()
    return res


def phase_lm_train(dev) -> dict:
    """llama3.2-3b train_4k at FULL width (bf16, chunked attention, remat,
    adamw), batch LM_TRAIN_BATCH at S = 4096 (``lm_train_steps``, one
    gradient pass profiled); then the 2-layer FULL-width f32 copy held to
    the CPU."""
    import torch

    t_phase = time.perf_counter()
    res = {"phase": "lm_train", **lm_train_steps(dev, LM_ARCH,
                                                  LM_TRAIN_BATCH)}
    if res["attn_impl"] != "chunked":
        raise AssertionError(f"{LM_ARCH}: attention {res['attn_impl']}")
    torch.cuda.empty_cache()
    res["cpu_check"] = lm_train_check(dev)
    res["seconds"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# the recsys slice: MT-WnD, DIN, DIEN and the registry's recsys cells
# ---------------------------------------------------------------------------

RECSYS_SERVER = "T7"  # the V100 accelerator host type of core/devices.py
# DIEN's logits on the card against the CPU copy: f32 sums in other orders
# at each of 200 GRU and 200 AUGRU steps (the recurrence contracts, so they
# do not grow; the CPU tests see 1e-6 against the reference at T = 200)
DIEN_TOL = 1e-4
CELL_REPS = 5  # host-timed runs of a registry cell (after 3 warm-up runs)
# DIEN: rounds of one fused launch and its two recurrences timed in turn,
# so each round gives a share of loops in a launch measured beside it
PAIRED_REPS = 9
# candidates of a retrieval cell held to the CPU copy: blocks of this many
# at the start, across the first chunk boundary, at random and at the end
CHECK_BLOCK = 1024
# a bulk cell's click log is drawn in blocks of this many rows on threads
# (``cell_batch_blocks``)
DRAW_BLOCK_ROWS = 16384


@contextlib.contextmanager
def plain_k1():
    """K1's per-feature entry replaced by its plain version where the models
    reach it (``embedding_bag_local``), on the same tensors."""
    from repro_torch.kernels.embedding_bag import ref
    from repro_torch.models import embedding as emb

    saved = emb.embedding_bag_features
    emb.embedding_bag_features = ref.embedding_bag_features_ref
    try:
        yield
    finally:
        emb.embedding_bag_features = saved


def cpu_copy(model):
    """The same model with its parameters copied to the host."""
    from repro_torch.common.tree import tree_map

    return type(model)(model.cfg, tree_map(lambda t: t.detach().cpu(),
                                           model.tree()))


def params_gb(model) -> float:
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def served(out: dict, sla_ms: float) -> dict:
    """The serving numbers of a ``serve`` result beside the SLA."""
    keys = ("schedule", "served_queries", "items", "fused_launches",
            "warmup_launches", "p50_ms", "p95_ms", "p99_ms", "wall_s")
    return {**{k: out[k] for k in keys}, "sla_ms": sla_ms,
            "p99_within_sla": out["p99_ms"] <= sla_ms}


def recsys_mt_wnd(dev, bw: float, f32_rate: float) -> dict:
    """(a) mt-wnd prod (26 x 20,000,000 x 32 deep and a dim-1 wide table,
    68.6 GB) served behind its T7 schedule: two K1 launches a fused launch,
    one kept launch against the same model with K1's plain version, the
    launch's stages, and K1 alone at the deep and the wide launch."""
    import torch

    from repro_torch.configs.paper_models import SLA_MS, mt_wnd, paper_profile
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch.serve_recsys import serve
    from repro_torch.models import widedeep
    from repro_torch.models.embedding import routed_offsets
    from repro_torch.models.recsys_base import batch_to_tensors

    cfg = mt_wnd(True)
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "recsys", "stage": "mt_wnd_memory",
          "free_gb_before_tables": free / 1e9, "total_gb": total / 1e9})
    torch.cuda.reset_peak_memory_stats()
    model = widedeep.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
    ops.launches = 0
    out = serve(cfg, paper_profile("mt-wnd"), RECSYS_SERVER, device=dev,
                n_queries=SERVE_QUERIES, qps=SERVE_QPS, seed=0, model=model,
                keep_launches=1)
    launches = ops.launches
    expected = 2 * (out["fused_launches"] + out["warmup_launches"])
    if not (launches > 0 and launches == expected == out["k1_launches"]):
        raise AssertionError(f"mt-wnd: K1 launches {launches} (serve counted "
                             f"{out['k1_launches']}), expected {expected}")

    batch_np, scores = out["kept"][0]
    d = out["schedule"]["batch"]
    if scores.shape != (d, cfg.n_tasks):
        raise AssertionError(f"mt-wnd scores {scores.shape}, expected "
                             f"({d}, {cfg.n_tasks})")
    with torch.inference_mode(), plain_k1():
        plain = model(batch_to_tensors(batch_np, dev))
    err = check("mt-wnd logits against K1's plain version",
                torch.from_numpy(scores), plain.float().cpu(), LOGIT_TOL)
    stages = launch_stages(model, batch_np, dev)

    # K1 alone at the two launches of a fused launch: the 2-D entry on the
    # shifted ids (as the kernel phase), the per-feature entry as served
    ids = torch.from_numpy(shifted_ids(batch_np["sparse_ids"],
                                       cfg.embedding.row_offsets)).to(dev)
    ids3 = torch.from_numpy(batch_np["sparse_ids"]).to(dev)
    stream = k1_stream(cfg, dev)
    k1 = {}
    # the tables as served: without autograd (the parameters train)
    for name, table, emb in (("deep", model.table.detach(), cfg.embedding),
                             ("wide", model.wide.detach(), model.wide_cfg)):
        off = routed_offsets(emb, dev)
        e = check(f"mt-wnd {name} K1", ops.hot_embedding_bag(table, ids),
                  ref.hot_embedding_bag_ref(table, ids), F32_TOL)
        torch.cuda.synchronize()
        k1[name] = {
            "case": f"mt_wnd_{name}", "table": list(table.shape),
            "dtype": "float32", "bags": ids.shape[0], "P": ids.shape[1],
            "max_abs_err": e, "tolerance": F32_TOL,
            **measure_k1(table, ids, bw, f32_rate, stream),
            "features_entry_ms": time_ms(
                lambda: ops.embedding_bag_features(table, ids3, off))}
        emit({"phase": "recsys", "stage": "k1", **k1[name]})
    res = {"model": cfg.name, "params_gb": params_gb(model),
           **served(out, SLA_MS["mt-wnd"]), "k1_launches": launches,
           "k1_launches_per_fused_launch": 2,
           "logits_shape": list(scores.shape),
           "logits_max_abs_err_vs_plain_k1": err, "logit_tolerance": LOGIT_TOL,
           "fused_launch_breakdown": stages,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "k1": k1}
    del model, plain, ids, ids3, stream
    torch.cuda.empty_cache()
    return res


def item_reach(cfg, batch_np) -> dict:
    """How far one launch's item ids (history and targets) reach against a
    QR item table's storage: the reference adds ``row_offsets[0]`` to the
    raw id, so an id past the stored rows reads another feature's rows or
    past the table."""
    import numpy as np

    emb = cfg.embedding
    hist = batch_np["history_ids"]
    items = np.concatenate([hist[hist >= 0], batch_np["target_id"]]).astype(
        np.int64) + int(emb.row_offsets[0])
    return {"item_ids": int(items.size), "max_item_id": int(items.max()),
            "stored_item_rows": emb.storage_rows(0),
            "share_past_item_storage": float(
                (items >= emb.row_offsets[1]).mean()),
            "share_past_table": float((items >= emb.total_rows).mean())}


def recsys_din(dev, name: str):
    """(b) / (c) din / dien prod (an 84.6 MB QR table, 200-step history)
    behind its T7 schedule: no K1 launch, one kept launch against the same
    model's CPU copy, every logit finite, the item ids past the QR storage,
    the launch's host time and (DIEN) its two recurrences' share."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import PAPER_MODELS, SLA_MS, paper_profile
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch.serve_recsys import serve
    from repro_torch.models import din
    from repro_torch.models.recsys_base import batch_to_tensors

    cfg = PAPER_MODELS[name](True)
    model = din.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                     device=dev)
    ops.launches = 0
    out = serve(cfg, paper_profile(name), RECSYS_SERVER, device=dev,
                n_queries=SERVE_QUERIES, qps=SERVE_QPS, seed=0, model=model,
                keep_launches=1)
    if ops.launches or out["k1_launches"]:
        raise AssertionError(f"{name} launched K1 ({ops.launches}): its "
                             "lookups are plain gathers")
    batch_np, scores = out["kept"][0]
    d = out["schedule"]["batch"]
    if scores.shape != (d,) or not np.isfinite(scores).all():
        raise AssertionError(f"{name}: scores {scores.shape}, expected ({d},)"
                             ", all finite")
    tol = DIEN_TOL if cfg.use_gru else LOGIT_TOL
    with torch.inference_mode():
        want = cpu_copy(model)(batch_to_tensors(batch_np, torch.device("cpu")))
    err = check(f"{name} logits on the card against the CPU copy",
                torch.from_numpy(scores), want, tol)
    reach = item_reach(cfg, batch_np)
    if reach["max_item_id"] < reach["stored_item_rows"]:
        raise AssertionError(f"{name}: no item id past the QR feature's "
                             "stored rows; the QR lookup went untested")

    def fused():
        return model(batch_to_tensors(batch_np, dev)).float().cpu()

    with torch.inference_mode():
        if not cfg.use_gru:
            launch = {"host_ms": host_ms(fused)}
        else:
            p = model.tree()
            batch = batch_to_tensors(batch_np, dev)
            mask = batch["history_ids"] >= 0
            table = p["embedding"]["table"]
            hist_emb = din.item_rows(table, batch["history_ids"], cfg) * \
                mask[..., None].to(cfg.dtype)
            target = din.item_rows(table, batch["target_id"], cfg)
            states = din._run_gru(p["gru"], hist_emb)
            att = torch.softmax(torch.where(mask, din.attention_scores(
                p, states, target, mask, cfg), -1e30), dim=-1)
            runs = {"host_ms": fused,
                    "gru_ms": lambda: din._run_gru(p["gru"], hist_emb),
                    "augru_ms": lambda: din._gru_states(p["augru"], states,
                                                        att)[-1]}
            for fn in runs.values():
                host_ms(fn, reps=1)  # warm-up
            times = {k: [] for k in runs}
            for _ in range(PAIRED_REPS):
                for k, fn in runs.items():
                    times[k].append(host_ms(fn, reps=1, warmup=0))
            shares = [(g + a) / t for g, a, t in zip(
                times["gru_ms"], times["augru_ms"], times["host_ms"])]
            launch = {"paired_rounds": PAIRED_REPS}
            for k, ts in times.items():
                launch[k] = statistics.median(ts)
                launch[k + "_range"] = [min(ts), max(ts)]
            launch["gru_share"] = statistics.median(shares)
            launch["gru_share_range"] = [min(shares), max(shares)]
    line = {"model": cfg.name, "params_gb": params_gb(model),
            **served(out, SLA_MS[name]), "k1_launches": 0,
            "logits_shape": list(scores.shape), "logits_finite": True,
            "logits_max_abs_err_vs_cpu": err, "tolerance": tol,
            "item_reach": reach, "fused_launch": launch}
    return line, model, batch_np


def checked_candidates(n: int, seed: int):
    """Indices of the candidates held to the CPU copy: CHECK_BLOCK at the
    start, across the first chunk boundary of DIN's retrieval, at random
    and at the end."""
    import numpy as np

    from repro_torch.models.din import RETRIEVAL_CHUNK

    starts = np.clip([0, RETRIEVAL_CHUNK - CHECK_BLOCK // 2, n - CHECK_BLOCK],
                     0, max(n - CHECK_BLOCK, 0))
    rand = np.random.default_rng(seed).integers(0, n, CHECK_BLOCK)
    idx = np.unique(np.concatenate(
        [np.arange(s, s + CHECK_BLOCK) for s in starts] + [rand]))
    return idx[idx < n]


def bulk_batch(cell) -> bool:
    """A cell whose batch is too large for a whole-batch check: serve_bulk
    (262,144 rows), and a CTR ranker's retrieval_cand (its 1,000,000
    candidates scored as one bulk batch)."""
    return cell.shape.name == "serve_bulk" or (
        cell.shape.name == "retrieval_cand"
        and "candidate_ids" not in cell.batch_specs)


def held_rows(cell, model, batch_np: dict, rows, dev, k1: bool):
    """The reference scores of ``rows`` of a bulk batch: the cell run on
    those rows alone (a row's score depends on its own inputs only), with
    K1's plain version on ``dev`` where the path reaches K1, else on a CPU
    copy of the model -> (scores, what they are)."""
    import torch

    sub = {k: torch.from_numpy(v[rows]) for k, v in batch_np.items()}
    if k1:
        with plain_k1():
            want = cell.run(model, {k: v.to(dev) for k, v in sub.items()})
        return want["scores"].float().cpu(), "K1's plain version"
    return cell.run(cpu_copy(model), sub)["scores"].float().cpu(), \
        "the CPU copy"


def row_block_check(name: str, scores, rows, want, tol) -> float:
    """The rows ``rows`` of a bulk cell's whole-batch ``scores`` against
    their reference ``want`` (``held_rows``) by ``check``; the planted
    one-row fault must fail it: the middle checked row given the scores
    of the checked row whose reference lies furthest from its own."""
    import torch

    got = scores[torch.as_tensor(rows, device=scores.device)].float().cpu()
    err = check(name, got, want, tol)
    j = len(rows) // 2
    far = int((want - want[j]).abs().reshape(len(rows), -1).amax(1).argmax())
    bad = got.clone()
    bad[j] = got[far]
    must_fail(f"{name}, row {int(rows[j])} given row {int(rows[far])}'s "
              "scores", bad, want, tol)
    return err


@contextlib.contextmanager
def captured_k1(calls: list):
    """K1's per-feature entry as the models reach it, each call's (table,
    ids, row offsets) appended to ``calls``."""
    from repro_torch.models import embedding as emb

    real = emb.embedding_bag_features

    def fn(table, ids, row_offsets, **kw):
        calls.append((table, ids, row_offsets))
        return real(table, ids, row_offsets, **kw)

    emb.embedding_bag_features = fn
    try:
        yield
    finally:
        emb.embedding_bag_features = real


def k1_alone(table, ids3, offsets, rows, bw: float, f32_rate: float
             ) -> dict:
    """K1's per-feature entry alone at one launch a bulk cell made (its
    table, ids [B, F, P] and offsets): ``ms`` (median of CELL_REPS, warm
    L2), ``F.embedding_bag`` over the same bags (int32 ids, the valid
    slots only), and the card's bound (each distinct row, the ids, the
    offsets and the output moved once; an f32 add a live slot).  The
    plain version's [B, F, P, D] gather cannot be held whole at these
    shapes (213 GB at rm2 retrieval_cand): its time is that of the
    checked rows' bags."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops, ref

    B, nF, P = ids3.shape
    D, esize = table.shape[1], table.element_size()
    # the valid slots' combined-table rows in bag order, int32 (rows and
    # slots below 2**31), gathered in blocks of rows: a mask's indices are
    # int64
    flat, counts = [], []
    for blk in ids3.split(1 << 17):
        valid = blk >= 0
        flat.append((blk + offsets.to(torch.int32)[None, :, None])[valid])
        counts.append(valid.sum(dim=-1).reshape(-1))
    flat, counts = torch.cat(flat), torch.cat(counts)
    bag_off = torch.zeros(B * nF, dtype=torch.int64, device=ids3.device)
    bag_off[1:] = counts.cumsum(0)[:-1]
    bag_off = bag_off.to(torch.int32)
    del valid, counts
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=ids3.device)
    for part in flat.split(1 << 27):
        seen[part.long()] = True
    distinct = int(seen.sum())
    del seen
    n_valid = int(flat.numel())
    out_bytes = B * nF * D * esize
    n_bytes = distinct * D * esize + ids3.numel() * 4 + offsets.numel() * 8 \
        + out_bytes
    t_bytes, t_ops = n_bytes / bw * 1e3, n_valid * D / f32_rate * 1e3
    sub = ids3[torch.as_tensor(rows, device=ids3.device)]
    res = {"shape": f"table [{table.shape[0]}, {D}] "
                    f"{str(table.dtype).removeprefix('torch.')}, ids [{B}, "
                    f"{nF}, {P}] int32",
           "slots": ids3.numel(), "valid_ids": n_valid,
           "distinct_rows": distinct, "bags": B * nF,
           "ms": time_ms(lambda: ops.embedding_bag_features(
               table, ids3, offsets), reps=CELL_REPS),
           "library_ms": time_ms(lambda: F.embedding_bag(
               flat, table, bag_off, mode="sum"), reps=CELL_REPS),
           "plain_ms_checked_rows": time_ms(
               lambda: ref.embedding_bag_features_ref(table, sub, offsets),
               reps=CELL_REPS),
           "checked_rows": len(rows),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes}
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    del flat, bag_off, sub
    return res


def recsys_cell(dev, arch_id: str, shape: str, bw: float | None = None,
                f32_rate: float | None = None) -> dict:
    """(d) one registry cell at its FULL config on the card: the time of a
    run, its peak memory above its inputs, the K1 launches it made; held to
    K1's plain version where it reaches K1, else to a CPU copy of the same
    parameters (a retrieval cell on ``checked_candidates``).  A bulk cell
    (``bulk_batch``) is held on row blocks (``checked_candidates``' rows:
    ``held_rows``, ``row_block_check``), its click log drawn in blocks of
    rows (``cell_batch_blocks``; the draw's host seconds), and, given
    ``bw``, each K1 launch it made timed alone (``k1_alone``)."""
    import torch

    from repro_torch.data.clicklog import cell_batch, cell_batch_blocks
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch_id, shape, dev)
    model = cell.init_state(torch.Generator(dev).manual_seed(1))
    bulk = bulk_batch(cell)
    t0 = time.perf_counter()
    if bulk:
        batch_np = cell_batch_blocks(cell.cfg, cell.batch_specs, 11,
                                     DRAW_BLOCK_ROWS)
    else:
        batch_np = cell_batch(cell.cfg, cell.batch_specs, seed=11)
    draw_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    calls = []
    with captured_k1(calls):
        scores = cell.run(model, batch)["scores"]
    torch.cuda.synchronize()
    k1_launches = ops.launches
    peak_total = torch.cuda.max_memory_allocated()
    peak = peak_total - base
    tol = BF16_TOL if cell.cfg.dtype == torch.bfloat16 else LOGIT_TOL
    if bulk:
        rows = checked_candidates(cell.batch, seed=12)
        want, against = held_rows(cell, model, batch_np, rows, dev,
                                  bool(k1_launches))
        err = row_block_check(f"{arch_id} {shape} rows against {against}",
                              scores, rows, want, tol)
        checked = len(rows)
    elif k1_launches:
        with plain_k1():
            want = cell.run(model, batch)["scores"]
        against = "K1's plain version"
        err = check(f"{arch_id} {shape} against {against}", scores, want, tol)
        checked = scores.shape[-1]
    else:
        cpu = cpu_copy(model)
        tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        got = scores.cpu()
        if "candidate_ids" in tb:
            pick = checked_candidates(tb["candidate_ids"].shape[0], seed=12)
            tb["candidate_ids"] = tb["candidate_ids"][pick]
            got = got[..., pick]
        against = "the CPU copy"
        want = cell.run(cpu, tb)["scores"]
        err = check(f"{arch_id} {shape} against {against}", got, want, tol)
        checked = got.shape[-1]
    res = {"arch": arch_id, "shape": shape, "config": cell.cfg.name,
           "batch": cell.batch, "scores_shape": list(scores.shape),
           "params_gb": params_gb(model),
           "ms": host_ms(lambda: cell.run(model, batch), reps=CELL_REPS),
           "peak_gb_above_inputs": peak / 1e9, "peak_gb": peak_total / 1e9,
           "k1_launches": k1_launches,
           "checked_against": against, "checked_scores": checked,
           "max_abs_err": err, "tolerance": tol}
    if bulk:
        res.update(rows_held="first, last, across the 32,768-row chunk "
                             "boundary and random blocks of "
                             f"{CHECK_BLOCK}", planted_faults_failed=1,
                   draw_s=draw_s,
                   draw=f"cell_batch_blocks: blocks of {DRAW_BLOCK_ROWS} "
                        "rows, each from its own seed")
    if bulk and bw is not None and calls:
        res["k1_alone"] = [k1_alone(*c, rows, bw, f32_rate) for c in calls]
    del model, batch, scores, calls
    torch.cuda.empty_cache()
    return res


RECSYS_CELLS = [(a, "serve_p99") for a in ("wide-deep", "din", "mind",
                                           "dlrm-rm2")] + \
    [(a, "retrieval_cand") for a in ("din", "mind")]


def phase_recsys(dev, bw: float, f32_rate: float) -> dict:
    """The recsys slice: (a) mt-wnd, (b) din, (c) dien at production width
    behind their T7 schedules, (d) the registry's recsys cells, then one
    fused din and dien launch each under torch.profiler."""
    import torch

    from repro_torch.models.recsys_base import batch_to_tensors

    res = {"phase": "recsys", "server": RECSYS_SERVER}
    res["mt_wnd"] = recsys_mt_wnd(dev, bw, f32_rate)
    emit({"phase": "recsys", "stage": "mt_wnd", **res["mt_wnd"]})
    kept = {}
    for name in ("din", "dien"):
        res[name], model, batch_np = recsys_din(dev, name)
        emit({"phase": "recsys", "stage": name, **res[name]})
        kept[name] = (model, batch_np)
    res["cells"] = []
    for arch_id, shape in RECSYS_CELLS:
        res["cells"].append(recsys_cell(dev, arch_id, shape))
        emit({"phase": "recsys", "stage": "cell", **res["cells"][-1]})
    # last: under torch.profiler's tracing the host-bound launches after it
    # run slower
    for name, (model, batch_np) in kept.items():
        with torch.inference_mode():
            res[name]["fused_launch"]["profiled"] = profile_step(
                lambda: model(batch_to_tensors(batch_np, dev)).float().cpu())
    res["k1_launches"] = res["mt_wnd"]["k1_launches"] + sum(
        c["k1_launches"] for c in res["cells"])
    del kept
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# training (K1's backward)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3    # steps of each FULL train cell, on one fixed batch
TRAIN_RECSYS = ("dlrm-rm2", "wide-deep", "din", "mind")
TRAIN_GNN = ("ogb_products", "minibatch_lg", "full_graph_sm", "molecule")
# minibatch_lg samples its seeds' fixed fanout from a graph of the shape's
# 232,965 nodes at this many edges a node, cut from the shape's 492 (the
# step's shapes are the fanout's; building the whole graph took ~65 s)
MINI_GRAPH_DEGREE = 32
# K1 tables of each recsys interaction (wide-deep: the deep and the wide)
K1_TABLES = {"dot": 1, "concat": 2, "target-attn": 0, "multi-interest": 0}
GRAD_BATCH = 2048  # the recsys gradient checks' batch (a CPU copy runs it)
# f32 gradients on the card against the CPU copy: sums in other orders in
# the matrix products, K1's backward and index_add (the tests see 1e-6)
GRAD_TOL = 1e-4
AGG_NODES = 65536  # ogb_products' aggregate held on these nodes' in-edges
GRAD_REPS = 5      # timed runs of K1's backward and its yardsticks
# Seconds the card is left idle before each of them is timed.  For ~0.1 s
# after a torch.cuda.empty_cache() that frees tens of GB of cached
# blocks, K1's backward ran ~10% slower on the H100, at the same SM clock
# (1980 MHz) and with no allocation in the calls; after an idle wait its
# first calls ran as fast as its later ones (tools/k1_bench.py --settle).
GRAD_SETTLE_S = 1.0


def settle() -> None:
    """Wait for the card, then leave it idle for GRAD_SETTLE_S."""
    import torch

    torch.cuda.synchronize()
    time.sleep(GRAD_SETTLE_S)


def tree_gb(tree) -> float:
    from repro_torch.common.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9


def flat(tree):
    """The tensors of a pytree as one float32 vector on the host."""
    import torch

    from repro_torch.common.tree import tree_leaves

    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in tree_leaves(tree)])


def train_cell(dev, arch_id: str, shape: str):
    """One FULL train cell on the card: TRAIN_STEPS steps on one fixed
    batch from a seed (host seconds of the click log, or of the graph and
    its sampler), the loss at each step and after the last, the median
    step ms (host clock, synchronised), peak memory, parameter and
    optimizer-state GB.  Returns the line, the cell, its state and batch."""
    import numpy as np
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data import clicklog, graph
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch_id, shape, dev)
    if cell.dims is not None and "batch_nodes" in cell.dims:
        cell.dims = {**cell.dims, "graph_degree": MINI_GRAPH_DEGREE}
    t0 = time.perf_counter()
    data = {}
    if cell.dims is None:
        batch_np = clicklog.cell_batch(cell.cfg, cell.batch_specs, seed=21)
    else:
        g = graph.cell_graph(cell.cfg, cell.dims, seed=21)
        if g is not None:
            data["graph_host_s"] = time.perf_counter() - t0
            data["graph_edges"] = g.n_edges
        t1 = time.perf_counter()
        batch_np = graph.cell_batch(cell.cfg, cell.dims, seed=21, graph=g)
        data["sampler_host_s" if cell.cfg.mode == "mini"
             else "batch_host_s"] = time.perf_counter() - t1
        del g
    data["data_host_s"] = time.perf_counter() - t0
    m0 = mem()
    # in the cell's dtypes (the click log's dense features and labels are
    # float32; a bf16 model casts them on entry, so the values are alike)
    batch = {k: torch.from_numpy(v).to(dev, cell.batch_specs[k].dtype)
             for k, v in batch_np.items()}
    state = cell.init_state(torch.Generator(dev).manual_seed(2))
    growth = mem() - m0
    args = list(batch.values()) + tree_leaves(state["model"].tree()) + \
        tree_leaves(state["opt"])
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, out = cell.run(state, batch)
        losses.append(float(out["loss"]))
        times.append((time.perf_counter() - t) * 1e3)
        if len(times) == 1:
            step_mem = mem_reading(growth, args, m0 + growth, mem_peak())
    with torch.no_grad():
        after = float(cell.loss_fn(state["model"], batch))
    # where a step goes: the loss and gradients alone (no update), once
    torch.cuda.synchronize()
    t = time.perf_counter()
    grads = cell.value_and_grad(state, batch)[1]
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t) * 1e3
    del grads
    if not (np.isfinite(losses).all() and np.isfinite(after)
            and after < losses[0]):
        raise AssertionError(f"{arch_id} {shape}: losses {losses}, then "
                             f"{after}: not finite, or not below the first")
    line = {"arch": arch_id, "shape": shape, "config": cell.cfg.name,
            "batch": cell.batch, "dims": cell.dims, "steps": TRAIN_STEPS,
            "losses": losses, "loss_after": after, "step_ms": times,
            "median_step_ms": statistics.median(times),
            "grad_ms": grad_ms,
            "update_ms": statistics.median(times) - grad_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_gb": tree_gb(state["model"].tree()),
            "opt_state_gb": tree_gb(state["opt"]), "memory": step_mem,
            **data}
    return line, cell, state, batch_np


def grad_faults(name, want, wrong: dict, tol) -> None:
    """Planted faults of a gradient check: zeros and each of ``wrong``."""
    import torch

    must_fail(f"{name}, zeros", torch.zeros_like(want), want, tol)
    for what, w in wrong.items():
        must_fail(f"{name}, {what}", w, want, tol)


def cpu_cell(cell):
    """The same cell on the host (its CPU copy runs the checks)."""
    import dataclasses

    import torch

    return dataclasses.replace(cell, device=torch.device("cpu"))


def rolled_labels(batch):
    return {**batch, "labels": batch["labels"].roll(1, dims=0)}


def gnn_check(dev, cell, state, batch_np) -> dict:
    """A GNN cell's gradients on the card against its CPU copy on the same
    batch, relative to the largest gradient, with planted faults (zeros,
    the gradients of the labels rolled by one)."""
    import torch

    host = cpu_cell(cell)
    model = cpu_copy(state["model"])
    cpu_state = {"model": model, "opt": host.opt.init(model.tree())}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    _, grads = cell.value_and_grad(state, {k: v.to(dev)
                                           for k, v in batch.items()})
    _, want = host.value_and_grad(cpu_state, batch)
    name = f"{cell.shape.name} gradients against the CPU copy"
    want = flat(want)
    err = check(name, flat(grads), want, GRAD_TOL)
    grad_faults(name, want, {"labels rolled": flat(host.value_and_grad(
        cpu_state, rolled_labels(batch))[1])}, GRAD_TOL)
    return {"grads_max_abs_err_vs_cpu": err, "grads_tolerance": GRAD_TOL,
            "grads_max": float(want.abs().max())}


def ogb_check(dev, cell, state, batch_np) -> dict:
    """ogb_products: layer 1's ``aggregate_full`` on the card against the
    CPU on the in-edges of the first AGG_NODES nodes (planted faults: zeros,
    the sum without the mean, the out-edges), and every gradient of a step
    finite."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.models.gnn import aggregate_full

    feats = torch.from_numpy(batch_np["feats"])
    edges = batch_np["edges"]
    n = feats.shape[0]
    k = int((edges[1] < AGG_NODES).sum())  # edges are sorted by dst
    sub = torch.from_numpy(edges[:, :k])
    with torch.no_grad():
        got = aggregate_full(feats.to(dev), torch.from_numpy(edges).to(dev),
                             n)[:AGG_NODES].cpu()
        want = aggregate_full(feats, sub, n)[:AGG_NODES]
        err = check("ogb_products aggregate_full", got, want, F32_TOL)
        grad_faults("ogb_products aggregate_full", want, {
            "sum, not mean": aggregate_full(feats, sub, n, "sum")[:AGG_NODES],
            "out-edges": aggregate_full(feats, sub.flip(0), n)[:AGG_NODES]},
            F32_TOL)
    _, grads = cell.value_and_grad(state, {k: torch.from_numpy(v).to(dev)
                                           for k, v in batch_np.items()})
    if not all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads)):
        raise AssertionError("ogb_products: a gradient is not finite")
    return {"aggregate_nodes": AGG_NODES, "aggregate_edges": k,
            "aggregate_max_abs_err_vs_cpu": err, "tolerance": F32_TOL,
            "grads_finite": True}


def unique_rows_grad(g, ids3, offsets):
    """K1's plain backward restricted to the rows the ids read: the rows
    ``u`` (sorted) and their gradient [len(u), D] (a dense plain gradient
    of dlrm-rm2 FULL would be 33 GB in f32 beside the kernel's)."""
    import torch

    from repro_torch.kernels.embedding_bag import ref

    rows = ref.shift_feature_ids(ids3, offsets)
    valid = rows >= 0
    u, inv = torch.unique(rows[valid], return_inverse=True)
    compact = torch.full_like(rows, -1)
    compact[valid] = inv
    zeros = torch.zeros_like(offsets)
    return u, lambda grad, cid=compact.to(torch.int32): \
        ref.embedding_bag_features_grad_ref(grad, cid, zeros, u.numel())


def once_per_bag(ids3):
    """ids [B, F, P] with a bag's repeated ids dropped (-1): the planted
    fault of counting a row read twice in a bag once."""
    import torch

    s, _ = ids3.sort(dim=2)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[..., 1:] = (s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)
    return torch.where(rep, -1, s)


def first_pair_only(ids3, offsets):
    """ids [B, F, P] with every pair but the first of each row dropped
    (-1): the planted fault of a row that takes one pair's gradient where
    the batch read it several times (a write where a sum belongs)."""
    import torch

    from repro_torch.kernels.embedding_bag import ref

    rows = ref.shift_feature_ids(ids3, offsets).reshape(-1)
    s, perm = torch.sort(rows, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[1:] = (s[1:] == s[:-1]) & (s[1:] >= 0)
    drop = torch.empty_like(rep)
    drop[perm] = rep
    return torch.where(drop.reshape(ids3.shape), -1, ids3)


def k1_grad_touched(dev, name: str, ids3, emb, seed: int):
    """K1's backward at a train launch (the cell's own ids, a random pooled
    gradient in the table's dtype): against its plain version on the
    touched rows (a dense plain gradient at FULL vocabularies would not fit
    beside the kernel's; in float64 for an f32 table, as in
    ``k1_grad_whole``), planted faults (zeros, the next bag's gradient, a
    row read by several pairs given one pair's, and where bags hold more
    than one id a row read twice in a bag counted once), every untouched
    row exactly zero, two launches bitwise equal -> (record, g, offsets)."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.embedding import routed_offsets

    H, D = emb.total_rows, emb.dim
    off = routed_offsets(emb, dev)
    g = torch.empty((*ids3.shape[:2], D), device=dev).normal_(
        generator=torch.Generator(dev).manual_seed(seed)).to(emb.dtype)
    got = ops.embedding_bag_features_grad(g, ids3, off, H)
    same = bool(torch.equal(got, ops.embedding_bag_features_grad(
        g, ids3, off, H)))
    if not same:
        raise AssertionError(f"K1's backward at {name}: two launches differ")
    bf16 = emb.dtype == torch.bfloat16
    tol = BF16_TOL if bf16 else F32_TOL
    # the plain version's dtype: bf16 rounds as the cell's own gradient
    # does; f32 is compared in float64
    as_plain = (lambda t: t) if bf16 else (lambda t: t.double())
    u, plain = unique_rows_grad(g, ids3, off)
    want = plain(as_plain(g))
    label = f"K1 backward at {name} (touched rows)"
    err = check(label, got[u], want, tol)
    # each fault keeps every row read, so the rows are u
    wrong = {"next bag's gradient": plain(as_plain(g.roll(1, dims=0))),
             "a row given one pair's gradient": unique_rows_grad(
                 g, first_pair_only(ids3, off), off)[1](as_plain(g))}
    if ids3.shape[2] > 1:
        wrong["a repeated id counted once"] = unique_rows_grad(
            g, once_per_bag(ids3), off)[1](as_plain(g))
    grad_faults(label, want, wrong, tol)
    del want, wrong
    got[u] = 0
    if bool(got.any()):
        raise AssertionError(f"K1's backward at {name} wrote an untouched "
                             "row")
    del got
    torch.cuda.empty_cache()
    valid = int((ref.shift_feature_ids(ids3, off) >= 0).sum())
    return ({"case": name, "table": [H, D], "dtype": str(emb.dtype),
             "ids": list(ids3.shape), "valid_pairs": valid,
             "touched_rows": int(u.numel()), "max_abs_err": err,
             "tolerance": tol, "bitwise_repeat": same,
             "untouched_rows_zero": True}, g, off)


def measure_k1_grad(g, ids3, off, H: int, bw: float, f32_rate: float
                    ) -> dict:
    """K1's backward on the pooled gradient ``g`` [B, F, D], ids [B, F, P]
    and offsets, timed beside its plain version (dense, float32), the
    autograd of ``F.embedding_bag(mode="sum")`` on the same ids and its
    bound.  The bound's bytes are the function's own: the pooled gradient
    and the ids read once, the dense gradient written once; the sorted
    design's traffic (a pooled-gradient row read for every valid pair) is
    ``algo_bytes`` beside it.  All three are timed after ``settle()`` and
    3 untimed calls; ``ms_first`` is the kernel right after the checks
    (their ``empty_cache``), with no wait; ``sm_mhz`` and ``sm_mhz_first``
    the SM clock's [min, median, max] over the two windows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops, ref

    D = g.shape[-1]
    rows = ref.shift_feature_ids(ids3, off).reshape(-1, ids3.shape[2])
    keep = (rows >= 0) & (rows < H)
    valid = int(keep.sum())
    esize = g.element_size()
    ids_bytes = ids3.numel() * ids3.element_size()
    n_bytes = g.numel() * esize + ids_bytes + H * D * esize
    algo_bytes = valid * D * esize + ids_bytes + H * D * esize
    t_bytes, t_ops = n_bytes / bw * 1e3, valid * D / f32_rate * 1e3

    def entry():
        return ops.embedding_bag_features_grad(g, ids3, off, H)

    first, steady = SmClock(), SmClock()
    with first:
        ms_first = time_ms(entry, reps=GRAD_REPS, clock=first)
    settle()
    with steady:
        ms = time_ms(entry, reps=GRAD_REPS, clock=steady)
    torch.cuda.empty_cache()
    flat_ids = rows[keep]
    bag_off = torch.zeros(rows.shape[0], dtype=torch.long, device=g.device)
    bag_off[1:] = keep.sum(dim=1).cumsum(0)[:-1]
    table = torch.zeros((H, D), dtype=g.dtype, device=g.device,
                        requires_grad=True)
    pooled = F.embedding_bag(flat_ids, table, bag_off, mode="sum")
    g2 = g.reshape(-1, D)
    settle()
    library_ms = time_ms(lambda: torch.autograd.grad(
        pooled, table, g2, retain_graph=True), reps=GRAD_REPS)
    del table, pooled, flat_ids, bag_off, rows, keep
    torch.cuda.empty_cache()
    settle()
    plain_ms = time_ms(lambda: ref.embedding_bag_features_grad_ref(
        g, ids3, off, H), reps=GRAD_REPS)
    torch.cuda.empty_cache()
    bound_ms = max(t_bytes, t_ops)
    return {"ms": ms, "sm_mhz": steady.window(), "ms_first": ms_first,
            "sm_mhz_first": first.window(),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "algo_bytes": algo_bytes,
            "algo_bytes_ms": algo_bytes / bw * 1e3,
            "share_of_bound": bound_ms / ms}


def k1_grad_stages(g, ids3, off, H: int) -> dict:
    """K1's backward at one launch stage by stage (CUDA events, median of
    GRAD_REPS, after ``settle()``): ``pairs`` (the valid pairs from the int32 ids), ``sort``
    (the radix sort by row, each run on the pairs as emitted), ``sum`` (the
    touched rows) and ``write`` (zeros into the other rows), with
    torch.sort's time on the same compacted rows beside the sort (sorting
    them with their int64 permutation: a yardstick, not on the path), the
    run lengths and the scratch."""
    import torch

    from repro_torch.kernels.embedding_bag.embedding_bag import GradLaunch

    D = g.shape[-1]
    call = GradLaunch(g.reshape(-1, D).contiguous(), ids3.contiguous(), off,
                      H)
    settle()
    res = {"pairs_ms": time_ms(lambda: call.run(call.PAIRS), reps=GRAD_REPS)}
    rows = call.pairs()[0].clone()
    res["sort_ms"] = time_ms(lambda: call.run(call.SORT), reps=GRAD_REPS,
                             before=lambda: call.run(call.PAIRS))
    res["torch_sort_ms"] = time_ms(lambda: torch.sort(rows, stable=True),
                                   reps=GRAD_REPS)
    del rows
    call.run(call.PAIRS | call.SORT)
    res["sum_ms"] = time_ms(lambda: call.run(call.SUM), reps=GRAD_REPS)
    res["write_ms"] = time_ms(lambda: call.run(call.WRITE), reps=GRAD_REPS)
    runs = torch.unique_consecutive(call.sorted_pairs()[0],
                                    return_counts=True)[1]
    res.update(valid_pairs=int(runs.sum()), touched_rows=int(runs.numel()),
               longest_run=int(runs.max()) if runs.numel() else 0,
               sort_bits=max(H - 1, 0).bit_length(),
               scratch_gb=call.scratch.numel() / 1e9)
    del call, runs
    torch.cuda.empty_cache()
    return res


def k1_grad_rm2(dev, ids3, emb, bw: float, f32_rate: float) -> dict:
    """K1's backward at the dlrm-rm2 train launch, checked by
    ``k1_grad_touched``, timed by ``measure_k1_grad`` and stage by stage
    by ``k1_grad_stages``."""
    res, g, off = k1_grad_touched(dev, "rm2_train_launch", ids3, emb, 5)
    H = res["table"][0]
    return {**res, **measure_k1_grad(g, ids3, off, H, bw, f32_rate),
            "stages": k1_grad_stages(g, ids3, off, H)}


def k1_grad_whole(dev, name: str, ids3, emb, dtype):
    """K1's backward against its whole dense plain version, run in
    float64 (a hot row sums thousands of pairs, whose float32 rounding in
    either order nears the f32 tolerance), on a random pooled gradient
    (planted faults: zeros, the next bag's gradient), every row compared
    -> (record, g, offsets)."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.embedding import routed_offsets

    H = emb.total_rows
    off = routed_offsets(emb, dev)
    g = torch.empty((*ids3.shape[:2], emb.dim), device=dev).normal_(
        generator=torch.Generator(dev).manual_seed(6)).to(dtype)
    got = ops.embedding_bag_features_grad(g, ids3, off, H)
    want = ref.embedding_bag_features_grad_ref(g.double(), ids3, off, H)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = check(f"K1 backward at {name}", got, want, tol)
    grad_faults(f"K1 backward at {name}", want, {
        "next bag's gradient": ref.embedding_bag_features_grad_ref(
            g.roll(1, dims=0).double(), ids3, off, H)}, tol)
    del want, got
    torch.cuda.empty_cache()
    return ({"case": name, "table": [H, emb.dim], "dtype": str(dtype),
             "ids": list(ids3.shape), "max_abs_err": err, "tolerance": tol},
            g, off)


def grad_step_check(dev, name: str, cell, state, batch, other,
                    lr: float) -> dict:
    """A recsys train cell's gradients on the card (``state``) against a
    CPU copy of the same parameters on the same batch (planted faults:
    zeros, the gradients of ``other``), K1 and its backward launched once a
    table, then one rowwise AdaGrad step (``lr``) on each given the CPU's
    gradients: the parameters at the model's tolerance (planted fault: the
    step at ten times ``lr``) and the accumulators at F32_TOL (planted
    fault: zeros).  ``batch`` and ``other`` are on the host."""
    import torch

    from repro_torch.common.tree import tree_map
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.train import optimizer as opt_lib

    host = cpu_cell(cell)
    model = cpu_copy(state["model"])
    cpu_state = {"model": model, "opt": host.opt.init(model.tree())}
    launches = (ops.launches, ops.grad_launches)
    _, grads = cell.value_and_grad(state, {k: v.to(dev)
                                           for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = (ops.launches - launches[0], ops.grad_launches - launches[1])
    tables = K1_TABLES[cell.cfg.interaction]
    if launches != (tables, tables):
        raise AssertionError(f"{name}: K1 launches {launches} in one "
                             f"gradient, expected {(tables, tables)}")
    _, want = host.value_and_grad(cpu_state, batch)
    bf16 = cell.cfg.dtype == torch.bfloat16
    tol = BF16_TOL if bf16 else GRAD_TOL
    label = f"{name} gradients against the CPU copy"
    err = check(label, flat(grads), flat(want), tol)
    grad_faults(label, flat(want), {"another batch": flat(
        host.value_and_grad(cpu_state, other)[1])}, tol)
    del grads

    wrong = type(model)(model.cfg, tree_map(lambda t: t.detach().clone(),
                                            model.tree()))
    opt_lib.rowwise_adagrad(lr=10 * lr).update(
        wrong.tree(), want, opt_lib.rowwise_adagrad().init(wrong.tree()))
    cell.opt.update(state["model"].tree(), tree_map(lambda t: t.to(dev), want),
                    state["opt"])
    host.opt.update(model.tree(), want, cpu_state["opt"])
    p_tol = BF16_TOL if bf16 else F32_TOL
    p_want = flat(model.tree())
    p_err = check(f"{name} AdaGrad step", flat(state["model"].tree()),
                  p_want, p_tol)
    must_fail(f"{name} AdaGrad step, ten times the learning rate",
              flat(wrong.tree()), p_want, p_tol)
    a_want = flat(cpu_state["opt"])
    a_err = check(f"{name} AdaGrad accumulators", flat(state["opt"]),
                  a_want, F32_TOL)
    must_fail(f"{name} AdaGrad accumulators, zeros",
              torch.zeros_like(a_want), a_want, F32_TOL)
    return {"k1_launches": list(launches),
            "grads_max_abs_err_vs_cpu": err, "grads_tolerance": tol,
            "step_params_max_abs_err": p_err, "params_tolerance": p_tol,
            "accumulators_max_abs_err": a_err}


def recsys_grad_check(dev, arch_id: str) -> dict:
    """``grad_step_check`` on a recsys train cell at FULL widths with
    vocabularies cut to 3,000 rows (``tests/torch_recsys_util.cut_vocab``),
    batch GRAD_BATCH, another click-log batch the planted fault."""
    import dataclasses

    import torch

    from repro_torch.data.clicklog import cell_batch
    from repro_torch.launch.steps import RECSYS_LR, build_cell

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_recsys_util import cut_vocab

    cell = build_cell(arch_id, "train_batch", dev, batch=GRAD_BATCH)
    cell = dataclasses.replace(cell, cfg=cut_vocab(cell.cfg))
    state = cell.init_state(torch.Generator(dev).manual_seed(3))
    batch, other = ({k: torch.from_numpy(v) for k, v in cell_batch(
        cell.cfg, cell.batch_specs, seed=seed).items()} for seed in (23, 24))
    res = {"arch": arch_id, "config": cell.cfg.name + " (vocab cut to 3000)",
           "batch": GRAD_BATCH,
           **grad_step_check(dev, arch_id, cell, state, batch, other,
                             RECSYS_LR)}
    del state
    torch.cuda.empty_cache()
    return res


def phase_train(dev, bw: float, f32_rate: float) -> dict:
    """Training on the card: (a) the recsys train_batch cells at FULL width
    (B = 65,536), K1's forward and backward launches counted from 0 over
    them; (b) GraphSAGE's four train cells at FULL width, each held to the
    CPU (ogb_products: one aggregate and finite gradients); (c) K1's
    backward against its plain version at the dlrm-rm2 train launch,
    dlrm-rmc1 prod and the wide-deep deep (f32, D = 32, past 2^31
    elements) and wide (D = 1) launches, with its times;
    (d) each recsys model's gradients and one AdaGrad step against a CPU
    copy at cut vocabularies."""
    import torch

    from repro_torch.configs.paper_models import rmc1
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models.widedeep import _wide_cfg

    t0 = time.perf_counter()
    res = {"phase": "train", "cells": []}
    kept_ids = {}
    ops.launches = 0
    ops.grad_launches = 0
    for arch_id in TRAIN_RECSYS:
        before = (ops.launches, ops.grad_launches)
        line, cell, state, batch_np = train_cell(dev, arch_id, "train_batch")
        tables = K1_TABLES[cell.cfg.interaction]
        line["k1_launches"] = ops.launches - before[0]
        line["k1_grad_launches"] = ops.grad_launches - before[1]
        # a launch a table a pass: the steps, the loss after them, and the
        # gradient timed alone
        if (line["k1_launches"], line["k1_grad_launches"]) != (
                tables * (TRAIN_STEPS + 2), tables * (TRAIN_STEPS + 1)):
            raise AssertionError(f"{arch_id}: K1 launches {line['k1_launches']}"
                                 f" forward, {line['k1_grad_launches']} "
                                 "backward, not one a table a pass")
        if tables:
            kept_ids[arch_id] = (cell.cfg, batch_np["sparse_ids"])
        emit({"phase": "train", "stage": "cell", **line})
        res["cells"].append(line)
        del cell, state, batch_np
        torch.cuda.empty_cache()
    res["k1_launches"] = ops.launches
    res["k1_grad_launches"] = ops.grad_launches

    for shape in TRAIN_GNN:
        line, cell, state, batch_np = train_cell(dev, "graphsage-reddit",
                                                 shape)
        check_fn = ogb_check if shape == "ogb_products" else gnn_check
        line["check"] = check_fn(dev, cell, state, batch_np)
        emit({"phase": "train", "stage": "cell", **line})
        res["cells"].append(line)
        del cell, state, batch_np
        torch.cuda.empty_cache()

    cfg, ids = kept_ids["dlrm-rm2"]
    res["k1_grad"] = {"rm2": k1_grad_rm2(
        dev, torch.from_numpy(ids).to(dev), cfg.embedding, bw, f32_rate)}
    emit({"phase": "train", "stage": "k1_grad", **res["k1_grad"]["rm2"]})
    rmc1_cfg = rmc1(True)
    cfg, ids = kept_ids["wide-deep"]
    ids = torch.from_numpy(ids).to(dev)

    def whole(name, ids, emb):
        return k1_grad_whole(dev, name, ids, emb, torch.float32)

    def touched(name, ids, emb):
        return k1_grad_touched(dev, name, ids, emb, 7)

    for case, name, case_ids, emb, checked in (
            ("rmc1", "rmc1_prod", torch.from_numpy(click_launches(
                rmc1_cfg, [3])[0]).to(dev), rmc1_cfg.embedding, whole),
            ("deep", "wide_deep_deep", ids, cfg.embedding, touched),
            ("wide", "wide_deep_wide", ids, _wide_cfg(cfg), whole)):
        line, g, off = checked(name, case_ids, emb)
        line.update(measure_k1_grad(g, case_ids, off, emb.total_rows, bw,
                                    f32_rate))
        res["k1_grad"][case] = line
        emit({"phase": "train", "stage": "k1_grad", **line})
        del g
        torch.cuda.empty_cache()
    del kept_ids
    torch.cuda.empty_cache()

    res["grad_checks"] = []
    for arch_id in TRAIN_RECSYS:
        res["grad_checks"].append(recsys_grad_check(dev, arch_id))
        emit({"phase": "train", "stage": "grad_check",
              **res["grad_checks"][-1]})
    res["seconds"] = time.perf_counter() - t0
    return res


# launch/train_dlrm through the checkpointing Trainer: run A uninterrupted,
# run B crashed before step TRAINER_CRASH_AT and resumed
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_CRASH_AT = 60, 20, 45
TRAINER_BATCH = 1024   # examples/train_dlrm.py's batch
TRAINER_TOL = 1e-6


def trainer_step_check(dev, bw: float, f32_rate: float) -> dict:
    """The first step of ``launch.train_dlrm`` (dlrm-100m from the seed of
    ``phase_trainer``'s runs, on step 0's batch), held part by part to its
    plain versions: (a) K1's per-feature entry on the step's table and ids
    (``k1_features_case``; planted faults: zeros, the next bag's rows),
    timed with its bound on the shifted ids (``measure_k1``); (b) K1's
    backward on the step's ids against its whole dense plain version
    (``k1_grad_whole``), timed (``measure_k1_grad``); (c) the step's
    gradients and its AdaGrad update against a CPU copy
    (``grad_step_check``, step 1's batch the planted fault)."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch import train_dlrm
    from repro_torch.models.embedding import routed_offsets

    cfg = train_dlrm.make_model()
    emb = cfg.embedding
    cell = train_dlrm.train_cell(cfg, TRAINER_BATCH, dev)
    state = cell.init_state(torch.Generator(dev).manual_seed(0))
    batches = train_dlrm.step_batches(cfg, TRAINER_BATCH, 0,
                                      torch.device("cpu"))(0)
    batch, other = next(batches), next(batches)

    table = state["model"].table.detach()
    ids3 = batch["sparse_ids"].to(dev)
    off = routed_offsets(emb, dev)
    flat_ids = torch.from_numpy(shifted_ids(batch["sparse_ids"].numpy(),
                                            emb.row_offsets)).to(dev)
    feat = k1_features_case(table, ids3, off,
                            ops.hot_embedding_bag(table, flat_ids))
    want = ref.embedding_bag_features_ref(table, ids3, off)
    must_fail("K1 at the train_dlrm step, zeros", torch.zeros_like(want),
              want, F32_TOL)
    must_fail("K1 at the train_dlrm step, the next bag's rows",
              want.roll(1, dims=0), want, F32_TOL)
    del want
    fwd = {"case": "train_dlrm_step", "table": list(table.shape),
           "dtype": str(table.dtype), "ids": list(ids3.shape),
           "bags": flat_ids.shape[0], "P": flat_ids.shape[1],
           "max_abs_err": feat["max_abs_err"], "tolerance": F32_TOL,
           "features_entry_ms": feat["ms"],
           **measure_k1(table, flat_ids, bw, f32_rate)}
    emit({"phase": "trainer", "stage": "k1", **fwd})
    del flat_ids
    grad, g, off = k1_grad_whole(dev, "train_dlrm_step", ids3, emb,
                                 table.dtype)
    grad.update(measure_k1_grad(g, ids3, off, emb.total_rows, bw, f32_rate))
    emit({"phase": "trainer", "stage": "k1_grad", **grad})
    del g, table
    step = {"batch": TRAINER_BATCH,
            **grad_step_check(dev, "train_dlrm", cell, state, batch, other,
                              train_dlrm.LR)}
    emit({"phase": "trainer", "stage": "step_check", **step})
    del state
    torch.cuda.empty_cache()
    return {"k1": fwd, "k1_grad": grad, "step": step}


def phase_trainer(dev, bw: float, f32_rate: float) -> dict:
    """``repro_torch.launch.train_dlrm`` (dlrm-100m: 8 x 400,000 x 32 f32
    tables, pooling 16; rowwise AdaGrad) with the checkpointing Trainer in
    a temporary directory removed at the end: run A for TRAINER_STEPS
    steps, a checkpoint every TRAINER_CKPT_EVERY; run B the same, crashed
    before step TRAINER_CRASH_AT, then resumed from its last commit.  B
    resumes after step 40 and ends at step 60 with A's loss and state
    (within TRAINER_TOL, bitwise reported); a committed state restores
    bitwise; the loss falls; K1 and its backward launched once a step.
    First ``trainer_step_check`` holds the step and its kernels to their
    plain versions (its launches are not counted)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch import train_dlrm

    t0 = time.perf_counter()
    step_check = trainer_step_check(dev, bw, f32_rate)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        def trainer(run):
            return train_dlrm.make_trainer(
                TRAINER_STEPS, TRAINER_BATCH, tmp / run, dev,
                ckpt_every=TRAINER_CKPT_EVERY, log_every=1)

        def gen():
            return torch.Generator(dev).manual_seed(0)

        ops.launches = ops.grad_launches = 0
        t = time.perf_counter()
        state_a, hist_a = trainer("a").run(gen())
        run_a_s = time.perf_counter() - t
        launches_a = (ops.launches, ops.grad_launches)
        crashed = trainer("b")
        try:
            crashed.run(gen(), crash_at=TRAINER_CRASH_AT)
        except RuntimeError as e:
            if "injected crash" not in str(e):
                raise
        else:
            raise AssertionError("run B did not crash")
        committed = crashed.ckpt.all_steps()
        resumed = trainer("b")
        state_b, hist_b = resumed.run(gen())
        launches = (ops.launches, ops.grad_launches)
        want_launches = TRAINER_STEPS + TRAINER_CRASH_AT + TRAINER_STEPS - \
            committed[-1]
        if committed != [20, 40] or hist_b[0]["step"] != 41 or \
                hist_b[-1]["step"] != TRAINER_STEPS or \
                resumed.ckpt.all_steps() != [20, 40, 60]:
            raise AssertionError(f"run B: committed {committed} at the crash, "
                                 f"resumed at step {hist_b[0]['step']}, ended "
                                 f"at {hist_b[-1]['step']}, commits "
                                 f"{resumed.ckpt.all_steps()}")
        if launches_a != (TRAINER_STEPS,) * 2 or \
                launches != (want_launches,) * 2:
            raise AssertionError(f"K1 launches {launches_a} in run A, "
                                 f"{launches} in all, expected one a step")
        loss_a, loss_b = hist_a[-1]["loss"], hist_b[-1]["loss"]
        check("train_dlrm resumed loss", torch.tensor(loss_b),
              torch.tensor(loss_a), TRAINER_TOL)
        leaves_a = [t.detach() for t in tree_leaves(
            [state_a["model"].tree(), state_a["opt"]])]
        leaves_b = [t.detach() for t in tree_leaves(
            [state_b["model"].tree(), state_b["opt"]])]
        err = max(check(f"train_dlrm resumed state leaf {i}", b, a,
                        TRAINER_TOL)
                  for i, (a, b) in enumerate(zip(leaves_a, leaves_b)))
        bitwise = all(bool(torch.equal(a, b))
                      for a, b in zip(leaves_a, leaves_b))
        fresh = resumed.init_state_fn(torch.Generator(dev).manual_seed(9))
        resumed.ckpt.restore(TRAINER_STEPS, fresh)
        restored = [t.detach() for t in tree_leaves(
            [fresh["model"].tree(), fresh["opt"]])]
        if not all(bool(torch.equal(a, b))
                   for a, b in zip(restored, leaves_b)):
            raise AssertionError("train_dlrm: the step-60 commit did not "
                                 "restore bitwise")
        first, last = hist_a[0]["loss"], loss_a
        if not last < first:
            raise AssertionError(f"train_dlrm: loss {first} -> {last}")
        steps_ms = [h["step_time_s"] * 1e3 for h in hist_a]
        ckpt_gb = sum(t.numel() * t.element_size() for t in leaves_a) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "trainer", "config": "dlrm-100m (8 x 400000 x 32 f32, "
            "pooling 16)", "batch": TRAINER_BATCH, "steps": TRAINER_STEPS,
            "ckpt_every": TRAINER_CKPT_EVERY, "crash_at": TRAINER_CRASH_AT,
            "committed_at_crash": committed,
            "resumed_from": hist_b[0]["step"] - 1,
            "losses_a": [h["loss"] for h in hist_a],
            "loss_b_final": loss_b, "state_max_abs_err": err,
            "tolerance": TRAINER_TOL, "bitwise_equal": bitwise,
            "restore_bitwise": True, "checkpoint_gb": ckpt_gb,
            "median_step_ms": statistics.median(steps_ms),
            "run_a_s": run_a_s, "k1_launches": launches[0],
            "k1_grad_launches": launches[1], "step_check": step_check,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the distributed layer: ranks on one card over gloo
# ---------------------------------------------------------------------------

# One card holds every rank: NCCL refuses two ranks on one device, so the
# ranks talk over gloo with CUDA tensors (each collective passes through
# the host; these are not multi-card NCCL times).
DIST_RANKS = 2
DIST_BACKEND = "gloo"
NCCL_BACKEND = "nccl"   # (d): one rank, so that the wrappers' NCCL path runs
RM2_SEED, LONG_SEED, MODULES_SEED, NCCL_SEED = 31, 32, 33, 34
CACHE_CHUNK = 1 << 16   # rows of one draw of the random long_500k cache
MOE_TOKENS = 4096       # the olmoe MoE layer's tokens
CE_SHAPE = (2, 4096)    # the vocab-parallel loss's batch and sequence
SUM_TOL = 2e-4          # f32 sums over reordered partials


def dist_line(stage: str, **kw) -> dict:
    return {"phase": "dist", "stage": stage, "ranks": DIST_RANKS,
            "backend": DIST_BACKEND, "one_card": True, **kw}


def long_cache(cfg, batch: int, S: int, lo: int, hi: int, seed: int, dev
               ) -> dict:
    """Rows [lo, hi) of a random S-row int8 KV cache (scales in [0.005,
    0.02]), each CACHE_CHUNK-row chunk of each layer and leaf drawn from a
    generator of its own: a rank's slice is bitwise those rows of the whole
    cache made from the same seed."""
    import torch

    L, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n_chunks = -(-S // CACHE_CHUNK)
    out = {}
    g = torch.Generator(dev)
    for i, name in enumerate(("k", "v", "ks", "vs")):
        last = 1 if name in ("ks", "vs") else hd
        dtype = torch.float32 if last == 1 else torch.int8
        t = torch.empty((L, batch, hi - lo, KVH, last), dtype=dtype,
                        device=dev)
        for layer in range(L):
            for c in range(lo // CACHE_CHUNK, -(-hi // CACHE_CHUNK)):
                c0, c1 = c * CACHE_CHUNK, min((c + 1) * CACHE_CHUNK, S)
                g.manual_seed(seed + (i * 4096 + layer) * n_chunks + c)
                shape = (batch, c1 - c0, KVH, last)
                if last == 1:
                    chunk = torch.empty(shape, device=dev).uniform_(
                        0.005, 0.02, generator=g)
                else:
                    chunk = torch.randint(-127, 128, shape, generator=g,
                                          device=dev, dtype=torch.int8)
                a, b = max(c0, lo), min(c1, hi)
                t[layer, :, a - lo:b - lo] = chunk[:, a - c0:b - c0]
        out[name] = t
    return out


def check_partials(name, got, want, tol) -> float:
    """K3's partials (m, l, o) against their plain version: the running max
    m and the sum l each by ``check``, and o as the attention it carries,
    o / l (o is a sum of up to a slice's rows, whose rounding grows with
    them; the merge divides it by l).  The largest error."""
    (gm, gl, go), (wm, wl, wo) = got, want
    return max(check(f"{name} m", gm, wm, tol),
               check(f"{name} l", gl, wl, tol),
               check(f"{name} o / l", go / gl.clamp_min(1e-30),
                     wo / wl.clamp_min(1e-30), tol))


def partials_must_fail(name, wrong, want, tol) -> None:
    try:
        check_partials(name, wrong, want, tol)
    except AssertionError:
        return
    raise AssertionError(f"{name}: a planted fault passed the check")


@contextlib.contextmanager
def checked_int8_partials(errs: list, tol: float):
    """Every call of K3's int8 partials on the sharded decode path held to
    its plain version (``errs`` gets each call's largest error); the first
    call's check also fed two planted faults that must fail it: each row
    read with the next row's scales, and a wrong ``kv_offset`` (the slice
    placed so that half of it lies past kv_len)."""
    from repro_torch.dist import decode as dd
    from repro_torch.kernels.flash_attention import ref

    saved = dd.flash_decode_int8_partials

    def wrapped(q, kq, ks, vq, vs, *, kv_len, kv_offset=0, bk=512):
        got = saved(q, kq, ks, vq, vs, kv_len=kv_len, kv_offset=kv_offset,
                    bk=bk)
        want = ref.flash_decode_int8_partials_ref(
            q, kq, ks, vq, vs, kv_len=kv_len, kv_offset=kv_offset)
        name = f"k3 int8 partials call {len(errs)}"
        errs.append(check_partials(name, got, want, tol))
        if len(errs) == 1:
            partials_must_fail(f"{name}, next row's scales",
                               ref.flash_decode_int8_partials_ref(
                                   q, kq, ks.roll(-1, dims=1), vq,
                                   vs.roll(-1, dims=1), kv_len=kv_len,
                                   kv_offset=kv_offset), want, tol)
            partials_must_fail(f"{name}, wrong kv_offset",
                               ref.flash_decode_int8_partials_ref(
                                   q, kq, ks, vq, vs, kv_len=kv_len,
                                   kv_offset=kv_len - kq.shape[1] // 2),
                               want, tol)
        return got

    dd.flash_decode_int8_partials = wrapped
    try:
        yield
    finally:
        dd.flash_decode_int8_partials = saved


def solo(rank: int, fn):
    """``fn()`` run by one rank at a time, the others waiting at a barrier,
    so that a rank's kernel times see the card alone; every rank's result
    in rank order (each rank gets its own, the others None)."""
    import torch
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == rank:
            out = fn()
            torch.cuda.synchronize()
    dist.barrier()
    return out


# --- (a) rm2 FULL, row-sharded -------------------------------------------


def rm2_reference(dev) -> dict:
    """dlrm-rm2 FULL's serve_p99 cell on one device (the whole 16.64 GB
    table): the pooled SparseNet output (K1) and the logits, on the host."""
    import torch

    from repro_torch.data.clicklog import cell_batch
    from repro_torch.launch.steps import build_cell

    cell = build_cell("dlrm-rm2", "serve_p99", dev)
    model = cell.init_fn(cell.cfg, device=dev,
                         generator=torch.Generator(dev).manual_seed(RM2_SEED))
    batch_np = cell_batch(cell.cfg, cell.batch_specs, seed=RM2_SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    with torch.inference_mode():
        pooled = model.apply_sparse(batch)
    logits = cell.run(model, batch)["scores"]
    out = {"batch": batch_np, "pooled": pooled.cpu(), "logits": logits.cpu(),
           "table_gb": params_gb(model),
           "step_ms": host_ms(lambda: cell.run(model, batch), reps=5)}
    del model, batch, pooled, logits
    torch.cuda.empty_cache()
    return out


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def rm2_rank(rank: int, mesh, dev, bw: float, f32_rate: float,
             ref: dict) -> dict:
    """(a) on one rank: its 65,000,192 rows of rm2's table, K1's row window
    against its plain version (planted faults: the neighbouring shard's
    rows, a dropped id) and timed, then the serve cell on the mesh against
    the single-device reference."""
    import torch
    import torch.nn.functional as F

    from repro_torch.dist import collectives, logical
    from repro_torch.dist.sharded_embedding import row_window
    from repro_torch.kernels.embedding_bag import ops, ref as k1_ref
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.embedding import routed_offsets

    t0 = time.perf_counter()
    cell = build_cell("dlrm-rm2", "serve_p99", dev, mesh=mesh)
    model = cell.init_state(torch.Generator(dev).manual_seed(RM2_SEED))
    batch = cell.local_batch({k: torch.from_numpy(v).to(dev)
                              for k, v in ref["batch"].items()})
    emb = cell.cfg.embedding
    table = model.table.detach()
    ids = batch["sparse_ids"].contiguous()
    off = routed_offsets(emb, dev)
    with logical.axis_rules(mesh, cell.rules):
        lo, hi = row_window(table)
    build_s = time.perf_counter() - t0
    # K1's row window at this launch, against its plain version
    got = ops.embedding_bag_features(table, ids, off, row_window=(lo, hi),
                                     out_dtype=torch.float32)
    want = k1_ref.embedding_bag_window_ref(table, ids, off, (lo, hi),
                                           torch.float32)
    err = check("k1 row window", got, want, F32_TOL)
    R = hi - lo
    other = (lo + R, hi + R) if lo == 0 else (lo - R, hi - R)
    must_fail("k1 row window, the neighbouring shard's rows",
              k1_ref.embedding_bag_window_ref(table, ids, off, other,
                                              torch.float32), want, F32_TOL)
    g = ids.long() + off[None, :, None]
    live = (ids >= 0) & (off[None, :, None] >= 0) & (g >= lo) & (g < hi)
    first = torch.nonzero(live)[0]
    dropped = ids.clone()
    dropped[tuple(first.tolist())] = -1
    must_fail("k1 row window, a dropped id",
              k1_ref.embedding_bag_window_ref(table, dropped, off, (lo, hi),
                                              torch.float32), want, F32_TOL)
    # the main path: the serve cell on the mesh, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.window_launches = 0
    collectives.reset()
    scores = cell.run(model, batch)["scores"]
    torch.cuda.synchronize()
    launches = ops.window_launches
    all_reduces = collectives.calls["all_reduce"]
    if launches < 1:
        raise AssertionError("the sharded rm2 cell launched no K1 window")
    with torch.inference_mode(), logical.axis_rules(mesh, cell.rules):
        pooled = model.apply_sparse(batch)
    pooled_err = drift(pooled, ref["pooled"].to(dev))
    ulp = bf16_ulp(float(ref["pooled"].float().abs().max()))
    if not pooled_err <= ulp:
        raise AssertionError(f"sharded rm2 pool off by {pooled_err} > one "
                             f"bf16 ulp {ulp}")
    flips = int((pooled != ref["pooled"].to(dev)).sum())
    logits_err = check("rm2 sharded logits", scores, ref["logits"].to(dev),
                       LOGIT_TOL)
    # times: K1's window alone (one rank at a time), its plain version,
    # F.embedding_bag on the window's ids remapped to local rows, the
    # all-reduce of the f32 partial (every rank), the sharded SparseNet and
    # the cell's step on the host clock
    flat = (g[live] - lo)
    offsets = torch.zeros(live.numel() // live.shape[-1], dtype=torch.long,
                          device=dev)
    offsets[1:] = live.reshape(-1, live.shape[-1]).sum(1).cumsum(0)[:-1]
    distinct = int(torch.unique(flat).numel())
    n_bytes = (distinct * table.shape[1] * table.element_size()
               + ids.numel() * 4 + got.numel() * 4)
    t_bytes = n_bytes / bw * 1e3
    t_ops = int(live.sum()) * table.shape[1] / f32_rate * 1e3
    scrub = torch.empty(100 * 2**20 // 4, device=dev)

    def window():
        return ops.embedding_bag_features(table, ids, off,
                                          row_window=(lo, hi),
                                          out_dtype=torch.float32)

    times = solo(rank, lambda: {
        "ms": time_ms(window),
        "ms_cold_l2": time_ms(window, before=scrub.zero_),
        "plain_ms": time_ms(lambda: k1_ref.embedding_bag_window_ref(
            table, ids, off, (lo, hi), torch.float32), reps=5),
        "library_ms": time_ms(lambda: F.embedding_bag(
            flat, table, offsets, mode="sum"))})
    part = window()
    all_reduce_ms = host_ms(lambda: collectives.all_reduce(
        part, mesh.group("model")))
    with torch.inference_mode(), logical.axis_rules(mesh, cell.rules):
        sparse_ms = host_ms(lambda: model.apply_sparse(batch))
    step_ms = host_ms(lambda: cell.run(model, batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = {"rank": rank, "coords": mesh.coords, "rows": [lo, hi],
           "table_gb": table.numel() * table.element_size() / 1e9,
           "build_s": build_s, "window_max_abs_err": err,
           "window_tolerance": F32_TOL, "launches": launches,
           "all_reduces": all_reduces, "pooled_max_abs_err": pooled_err,
           "pooled_tolerance_one_bf16_ulp": ulp,
           "pooled_elements_differing": flips,
           "logits_max_abs_err": logits_err, "logits_tolerance": LOGIT_TOL,
           **times, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "distinct_rows": distinct,
           "live_ids": int(live.sum()), "all_reduce_ms": all_reduce_ms,
           "all_reduce_bytes": part.numel() * 4, "sparse_ms": sparse_ms,
           "step_ms": step_ms, "peak_gb": peak}
    del model, table, batch, part, scrub
    torch.cuda.empty_cache()
    return res


# --- (b) llama3.2-3b FULL, long_500k, sequence-sharded --------------------


def long_reference(dev) -> dict:
    """long_500k on one device (the whole 31 GB int8 cache): the step's
    logits, the new token's K/V rows, the step's host time; then the f32
    witness (all 28 layers at FULL width) and its logits and rows."""
    import dataclasses

    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as tf_lib

    cell = build_cell(LM_ARCH, "long_500k", dev, batch=1)
    cfg, S = cell.cfg, cell.seq_len
    params = cell.init_state(torch.Generator(dev).manual_seed(LONG_SEED))
    cache = long_cache(cfg, 1, S, 0, S, LONG_SEED, dev)
    token = torch.randint(0, cfg.vocab, (1, 1), device=dev, dtype=torch.int32,
                          generator=torch.Generator(dev).manual_seed(
                              LONG_SEED + 1))
    batch = {"token": token, "cache": cache}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = cell.run(params, batch)["logits"]
    torch.cuda.synchronize()
    pos = S - 1
    out = {"token": token.cpu(), "logits": logits.cpu(),
           "new_row": {k: v[:, :, pos].cpu() for k, v in cache.items()},
           "cache_gb": sum(t.numel() * t.element_size()
                           for t in cache.values()) / 1e9,
           "params_gb": sum(t.numel() * t.element_size()
                            for t in tree_leaves(params)) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_ms": host_ms(lambda: cell.run(params, batch), reps=3)}
    del params, cache, batch, logits
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tf_lib.init(cfg32, device=dev,
                         generator=torch.Generator(dev).manual_seed(LONG_SEED))
    cache = long_cache(cfg32, 1, S, 0, S, LONG_SEED, dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out["logits_f32"] = tf_lib.decode_step(params, token, cache, pos,
                                               cfg32)[0].cpu()
    out["peak_gb_f32"] = torch.cuda.max_memory_allocated() / 1e9
    out["new_row_f32"] = {k: v[:, :, pos].cpu() for k, v in cache.items()}
    del params, cache
    torch.cuda.empty_cache()
    return out


def slice_sums(cache: dict, skip: int | None) -> list:
    """A checksum of every leaf of a cache slice, leaving out local row
    ``skip``: equal before and after a step iff no other row changed."""
    import torch

    out = []
    for t in cache.values():
        total = 0
        for layer in t.view(torch.int32):   # a layer at a time: int64 sums
            total += int(layer.sum(dtype=torch.int64))
            if skip is not None:
                total -= int(layer[:, skip].sum(dtype=torch.int64))
        out.append(total)
    return out


def vocab_slice(whole, local, mesh):
    """This rank's "model" block of the last axis of one device's
    ``whole`` logits, the slice its vocab-parallel ``local`` holds."""
    n, i = local.shape[-1], mesh.axis_index("model")
    return whole[..., i * n:(i + 1) * n]


def long_rank(rank: int, mesh, dev, bw: float, ref: dict) -> dict:
    """(b) on one rank: its 262,144 rows of the 524,288-row int8 cache
    (every kv head) and its block of the weights (12 of the 24 q heads, 4
    of the 8 kv heads, half the FFN and the vocabulary); the
    tensor-parallel long_500k step on the mesh (K3's int8 partials and the
    collectives counted from 0), again with every partials call held to
    its plain version, the new row against the single-device one, the
    step's time, parameter GB and peak, its memory against the dry run
    (phase ``dryrun`` (b)), K3's partials alone and the all-gather; then
    the f32 witness."""
    import dataclasses

    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.decode import seq_shard_index
    from repro_torch.kernels.flash_attention import ops, ref as k3_ref
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as tf_lib

    t0 = time.perf_counter()
    cell = build_cell(LM_ARCH, "long_500k", dev, batch=1, mesh=mesh)
    cfg, S = cell.cfg, cell.seq_len
    s_loc = cell.batch_specs["cache"]["k"].shape[2]
    off = seq_shard_index(mesh, cell.rules["kv_seq"]) * s_loc
    m0 = mem()
    params = cell.init_state(torch.Generator(dev).manual_seed(LONG_SEED))
    cache = long_cache(cfg, 1, S, off, off + s_loc, LONG_SEED, dev)
    token = ref["token"].to(dev)
    growth = mem() - m0
    batch = {"token": token, "cache": cache}
    pos = S - 1
    owner = off <= pos < off + s_loc
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    before = slice_sums(cache, pos - off if owner else None)
    torch.cuda.empty_cache()
    base = mem()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    # the main path: one step, counts from 0
    ops.launches["flash_decode_int8_partials"] = 0
    collectives.reset()
    logits = cell.run(params, batch)["logits"]
    torch.cuda.synchronize()
    launches = ops.launches["flash_decode_int8_partials"]
    calls = dict(collectives.calls)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_mem = mem_reading(growth, tree_leaves(params) + list(cache.values())
                           + [token], base, mem_peak())
    # a layer: one packed gather of the token's heads, one merge of the
    # partials, the wo and FFN all-reduces; the embedding's all-reduce
    want_calls = {"all_gather": 2 * cfg.n_layers,
                  "all_reduce": 2 * cfg.n_layers + 1,
                  "reduce_scatter": 0, "gather": 0}
    if launches != cfg.n_layers or calls != want_calls:
        raise AssertionError(f"long_500k step: {launches} K3 partials and "
                             f"collectives {calls} for {cfg.n_layers} "
                             f"layers, not {want_calls}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("long_500k: non-finite logits")
    # again, every partials call held to its plain version
    errs = []
    with checked_int8_partials(errs, BF16_TOL):
        again = cell.run(params, batch)["logits"]
    if not bool(torch.equal(again, logits)):
        raise AssertionError("long_500k: the checked step differs")
    # the cache: the new row on the rank that holds pos, nothing else moved;
    # layer 0's row against one device's (the same input, but a rank's
    # column blocks of wk and wv need not round as the whole product:
    # bitwise or within BF16_TOL dequantised), the deeper layers' reported
    # (the bf16 residual stream drifts with the merge's rounding; the f32
    # witness below holds them)
    after = slice_sums(cache, pos - off if owner else None)
    if after != before:
        raise AssertionError("long_500k: a row other than pos changed")
    row_err = row0_bitwise = row0_err = None
    if owner:
        # copies: a view would keep the whole slice alive after the cache
        row = {k: v[:, :, pos - off].clone() for k, v in cache.items()}
        want = {k: v.to(dev) for k, v in ref["new_row"].items()}
        row0_bitwise = all(bool(torch.equal(row[k][0], want[k][0]))
                           for k in ("k", "v", "ks", "vs"))
        row0_err = max(check(f"long_500k layer 0's new {k} row",
                             row[k][0].float() * row[sc][0],
                             want[k][0].float() * want[sc][0], BF16_TOL)
                       for k, sc in (("k", "ks"), ("v", "vs")))
        row_err = {k: drift(row[k], want[k]) for k in row}
    # times: the step (every rank), K3's partials on layer 0's slice alone
    # and its plain version (one rank at a time), the all-gather
    step_ms = host_ms(lambda: cell.run(params, batch), reps=5)
    lay = {k: v[0] for k, v in cache.items()}
    q = (torch.randn((1, 1, cfg.n_heads, cfg.head_dim), device=dev,
                     generator=torch.Generator(dev).manual_seed(5)) *
         PEAK).to(cfg.dtype)

    def partials():
        return ops.flash_decode_int8_partials(
            q, lay["k"], lay["ks"], lay["v"], lay["vs"], kv_len=S,
            kv_offset=off)

    times = solo(rank, lambda: {
        "partials_ms": time_ms(partials),
        "partials_plain_ms": time_ms(lambda: k3_ref.
                                     flash_decode_int8_partials_ref(
                                         q, lay["k"], lay["ks"], lay["v"],
                                         lay["vs"], kv_len=S,
                                         kv_offset=off), reps=3)})
    pm, pl, po = partials()
    partial_err = check_partials("k3 int8 partials, timed layer", (pm, pl, po),
                                 k3_ref.flash_decode_int8_partials_ref(
                                     q, lay["k"], lay["ks"], lay["v"],
                                     lay["vs"], kv_len=S, kv_offset=off),
                                 BF16_TOL)
    packed = torch.cat([pm, pl, po], dim=-1)
    seq_group = mesh.group(cell.rules["kv_seq"])
    gather_ms = host_ms(lambda: collectives.all_gather(packed, seq_group))
    n_bytes = attn_bytes(q, *lay.values(), pm, pl, po)
    t_bytes = n_bytes / bw * 1e3
    t_ops = 4 * cfg.n_heads * s_loc * cfg.head_dim / BF16_PEAK * 1e3
    res = {"rank": rank, "coords": mesh.coords, "rows": [off, off + s_loc],
           "cache_gb": sum(t.numel() * t.element_size()
                           for t in cache.values()) / 1e9,
           "params_gb": tree_gb(params), "memory": step_mem,
           "build_s": build_s, "launches": launches, "collectives": calls,
           "k3_vs_plain_max_abs_err_per_call": max(errs),
           "k3_checked_calls": len(errs), "tolerance": BF16_TOL,
           "logits_drift_from_one_device": drift(logits, vocab_slice(
               ref["logits"], logits, mesh).to(dev)),
           "new_row_owner": owner, "new_row_drift": row_err,
           "layer0_row_bitwise_one_device": row0_bitwise,
           "layer0_row_max_abs_err": row0_err,
           "step_ms": step_ms, "base_gb": base_gb,
           "step_peak_gb": step_peak_gb, **times,
           "partials_max_abs_err": partial_err,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "all_gather_ms": gather_ms,
           "all_gather_bytes": packed.numel() * 4}
    del params, cache, batch, lay, packed
    torch.cuda.empty_cache()
    # the f32 witness: all layers at FULL width, K3 held per call at the
    # f32 tolerance, every layer's new row and the logits held to one
    # device's
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = cell.local_params(tf_lib.init(
        cfg32, device=dev,
        generator=torch.Generator(dev).manual_seed(LONG_SEED)))
    torch.cuda.empty_cache()
    cache = long_cache(cfg32, 1, S, off, off + s_loc, LONG_SEED, dev)
    errs32 = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), logical.axis_rules(mesh, cell.rules), \
            checked_int8_partials(errs32, ATTN_F32_TOL):
        logits32 = tf_lib.decode_step(params, token, cache, pos, cfg32)[0]
    peak32_gb = torch.cuda.max_memory_allocated() / 1e9
    row32_err = None
    if owner:
        # every layer's new row: int8 codes within one step of one
        # device's (a code flips where the value sits on a rounding
        # boundary), scales at the f32 path's tolerance
        # copies: a view would keep the whole slice alive after the cache
        row = {k: v[:, :, pos - off].clone() for k, v in cache.items()}
        want = {k: v.to(dev) for k, v in ref["new_row_f32"].items()}
        row32_err = {k: drift(row[k], want[k]) for k in row}
        if row32_err["k"] > 1 or row32_err["v"] > 1:
            raise AssertionError(f"long_500k f32: new int8 rows off by "
                                 f"{row32_err}")
        check("long_500k f32 new row scales",
              torch.stack([row["ks"], row["vs"]]),
              torch.stack([want["ks"], want["vs"]]), F32_PATH_TOL)
    res["f32"] = {"layers": cfg32.n_layers, "new_row_drift": row32_err,
                  "peak_gb": peak32_gb,
                  "k3_vs_plain_max_abs_err_per_call": max(errs32),
                  "tolerance_per_call": ATTN_F32_TOL,
                  "logits_max_abs_err": check(
                      "long_500k f32 sharded logits", logits32,
                      vocab_slice(ref["logits_f32"], logits32, mesh).to(dev),
                      F32_PATH_TOL),
                  "logits_tolerance": F32_PATH_TOL}
    del params, cache
    torch.cuda.empty_cache()
    return res


# --- (c) the other dataflows ---------------------------------------------


def moe_inputs(dev):
    """olmoe's MoE layer at FULL width in f32, and MOE_TOKENS tokens."""
    import torch

    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.models.layers import init_moe

    cfg = olmoe_1b_7b.FULL.moe
    g = torch.Generator(dev).manual_seed(MODULES_SEED)
    params = init_moe(cfg, generator=g, device=dev, dtype=torch.float32)
    x = torch.randn((MOE_TOKENS, cfg.d_model), generator=g, device=dev)
    return cfg, params, x


def ce_inputs(dev):
    import torch

    from repro_torch.configs import llama3_2_3b

    V = llama3_2_3b.FULL.vocab
    g = torch.Generator(dev).manual_seed(MODULES_SEED + 1)
    logits = torch.randn((*CE_SHAPE, V), generator=g, device=dev)
    targets = torch.randint(0, V, CE_SHAPE, generator=g, device=dev)
    return logits, targets


def gnn_inputs(dev, shape: str):
    import torch

    from repro_torch.data.graph import cell_batch
    from repro_torch.launch.steps import build_cell

    cell = build_cell("graphsage-reddit", shape, dev)
    model = cell.init_state(torch.Generator(dev).manual_seed(
        MODULES_SEED + 2))["model"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             cell_batch(cell.cfg, cell.dims, MODULES_SEED).items()}
    return cell, model.tree(), batch


def modules_reference(dev) -> dict:
    """(c) on one device: the olmoe MoE layer, the loss at llama's
    vocabulary, GraphSAGE's full_graph_sm loss and molecule logits."""
    import torch

    from repro_torch.dist.loss import ce_loss
    from repro_torch.dist.moe import moe_apply
    from repro_torch.models import gnn as gnn_lib

    out = {}
    with torch.inference_mode():
        cfg, params, x = moe_inputs(dev)
        out["moe"] = moe_apply(params, x, cfg)[0].cpu()
        del params, x
        logits, targets = ce_inputs(dev)
        out["ce"] = float(ce_loss(logits, targets))
        del logits, targets
        cell, params, batch = gnn_inputs(dev, "full_graph_sm")
        out["full_graph_sm"] = float(gnn_lib.softmax_ce(
            gnn_lib.apply_full(params, batch["feats"], batch["edges"],
                               cell.cfg),
            batch["labels"], batch["label_mask"]))
        cell, params, batch = gnn_inputs(dev, "molecule")
        out["molecule"] = gnn_lib.apply_batched(
            params, batch["feats"], batch["edges"], batch["node_mask"],
            batch["graph_ids"], batch["labels"].shape[0], cell.cfg).cpu()
    torch.cuda.empty_cache()
    return out


def modules_rank(rank: int, mesh, dev, ref: dict) -> dict:
    """(c) on one rank, each against the single-device function: the
    olmoe MoE layer with its 64 experts split 32/32, the vocab-parallel
    loss on logits [2, 4096, 128256] split in halves, GraphSAGE's
    full_graph_sm (the edge list over both ranks) and molecule (its 128
    graphs over a (2, 1) mesh's data axis)."""
    import torch

    from repro_torch.dist import collectives, logical
    from repro_torch.dist.gnn import (
        apply_batched_sharded,
        apply_full_sharded,
        edge_block,
        graph_block,
    )
    from repro_torch.dist.loss import ce_loss
    from repro_torch.dist.moe import expert_parallel_specs, moe_apply
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.launch.mesh import Mesh

    res = {"rank": rank}
    collectives.reset()
    with torch.inference_mode():
        cfg, params, x = moe_inputs(dev)
        local = local_shard(params, expert_parallel_specs(params), mesh)
        del params
        torch.cuda.empty_cache()
        with logical.axis_rules(mesh, {"batch": "data", "model": "model"}):
            y = moe_apply(local, x, cfg)[0]
            t_ms = host_ms(lambda: moe_apply(local, x, cfg), reps=5)
        res["moe"] = {"experts_held": local["experts"]["w_gate"].shape[0],
                      "tokens": MOE_TOKENS,
                      "max_abs_err": check("olmoe MoE expert-parallel", y,
                                           ref["moe"].to(dev), SUM_TOL),
                      "tolerance": SUM_TOL, "ms": t_ms}
        del local, x, y
        logits, targets = ce_inputs(dev)
        half = local_shard(logits, P(None, None, "model"), mesh)
        del logits
        torch.cuda.empty_cache()
        with logical.axis_rules(mesh, {"batch": "data", "model": "model",
                                       "vocab": "model"}):
            loss = ce_loss(half, targets)
            t_ms = host_ms(lambda: ce_loss(half, targets), reps=5)
        res["ce"] = {"vocab_held": half.shape[-1],
                     "loss": float(loss), "reference": ref["ce"],
                     "max_abs_err": check("vocab-parallel CE",
                                          loss.reshape(1),
                                          torch.tensor([ref["ce"]],
                                                       device=dev), F32_TOL),
                     "tolerance": F32_TOL, "ms": t_ms}
        del half, targets
        cell, params, batch = gnn_inputs(dev, "full_graph_sm")
        edges = edge_block(batch["edges"], mesh)
        loss = apply_full_sharded(params, batch["feats"], edges,
                                  batch["labels"], batch["label_mask"],
                                  cell.cfg, mesh, batch["feats"].shape[0])
        res["full_graph_sm"] = {
            "edges_held": edges.shape[1], "loss": float(loss),
            "max_abs_err": check("full_graph_sm sharded loss",
                                 loss.reshape(1),
                                 torch.tensor([ref["full_graph_sm"]],
                                              device=dev), SUM_TOL),
            "tolerance": SUM_TOL}
        cell, params, batch = gnn_inputs(dev, "molecule")
        by_graph = Mesh((DIST_RANKS, 1), ("data", "model"),
                        device_type=dev.type)
        G = batch["labels"].shape[0]
        n, e = cell.dims["n_nodes"], cell.dims["n_edges"]
        block = graph_block(batch, by_graph, ("data",), G, n, e)
        logits, _ = apply_batched_sharded(params, block, cell.cfg, by_graph,
                                          ("data",), G, n, e)
        g = G // DIST_RANKS
        i = by_graph.axis_index("data")
        res["molecule"] = {
            "graphs_held": logits.shape[0],
            "max_abs_err": check("molecule sharded logits", logits,
                                 ref["molecule"][i * g:(i + 1) * g].to(dev),
                                 SUM_TOL),
            "tolerance": SUM_TOL}
    res["collectives"] = dict(collectives.calls)
    torch.cuda.empty_cache()
    return res


def dist_rank(rank: int, dev_type: str, bw: float, f32_rate: float,
              refs: dict) -> dict:
    """One rank of the dist phase: (a), (b) and (c) on a (1, DIST_RANKS)
    ("data", "model") mesh over the card."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh

    dev = torch.device(dev_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_debug_mesh(1, DIST_RANKS, device_type=dev_type)
    out = {}
    t0 = time.perf_counter()
    out["rm2"] = rm2_rank(rank, mesh, dev, bw, f32_rate, refs["rm2"])
    out["rm2"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["long"] = long_rank(rank, mesh, dev, bw, refs["long"])
    out["long"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["modules"] = modules_rank(rank, mesh, dev, refs["modules"])
    out["modules"]["seconds"] = time.perf_counter() - t0
    return out


# --- (d) NCCL, one rank --------------------------------------------------


def nccl_rank(rank: int, dev_type: str) -> dict:
    """(d) world size 1 over NCCL: (a)'s dataflow at train_dlrm's table
    (3.2 M x 32 f32) bitwise one device's, and the sequence-sharded int8
    decode's merge against K3's int8 entry: the NCCL path of the
    all-reduce and the all-gather."""
    import torch

    from repro_torch.data.clicklog import ClickLogGenerator
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.decode import flash_decode_sharded_int8
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train_dlrm import make_model
    from repro_torch.models.embedding import (
        embedding_bag,
        embedding_bag_local,
        init_embedding,
    )
    import torch.distributed as dist

    dev = torch.device(dev_type)
    mesh = make_debug_mesh(1, 1, device_type=dev_type)
    cfg = make_model()
    emb = cfg.embedding
    params = init_embedding(emb, device=dev, generator=torch.Generator(
        dev).manual_seed(NCCL_SEED))
    ids = torch.from_numpy(ClickLogGenerator(cfg, seed=NCCL_SEED).sparse_ids(
        TRAINER_BATCH)).to(dev)
    collectives.reset()
    ops.window_launches = 0
    with torch.inference_mode():
        with logical.axis_rules(mesh, {"batch": "data", "model": "model"}):
            sharded = embedding_bag(params, ids, emb)
        local = embedding_bag_local(params, ids, emb)
        if not bool(torch.equal(sharded, local)):
            raise AssertionError("NCCL world 1: the sharded pool differs "
                                 "from one device's")
        g = torch.Generator(dev).manual_seed(NCCL_SEED + 1)
        B, S, H, KVH, hd = 2, 4096, 24, 8, 128
        q = torch.randn((B, 1, H, hd), generator=g, device=dev) * PEAK
        kq, vq = (torch.randint(-127, 128, (B, S, KVH, hd), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.empty((B, S, KVH, 1), device=dev).uniform_(
            0.005, 0.02, generator=g) for _ in range(2))
        got = flash_decode_sharded_int8(q, kq, ks, vq, vs, kv_len=S - 100,
                                        mesh=mesh,
                                        seq_axes=("data", "model"))
        err = check("NCCL world 1 int8 decode", got, k3_ops.flash_decode_int8(
            q, kq, ks, vq, vs, kv_len=S - 100), ATTN_F32_TOL)
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "table": [emb.total_rows, emb.dim], "ids": list(ids.shape),
            "pool_bitwise_one_device": True, "window_launches":
            ops.window_launches, "decode_max_abs_err": err,
            "decode_tolerance": ATTN_F32_TOL,
            "collectives": dict(collectives.calls)}


def phase_dist(dev, bw: float, f32_rate: float) -> dict:
    """The distributed layer on the card: the single-device references
    first (each freed before the next), then DIST_RANKS rank processes on
    the card over gloo run (a) rm2 FULL row-sharded, (b) llama3.2-3b FULL
    long_500k sequence-sharded and (c) the MoE, loss and GNN dataflows;
    then (d) one rank over NCCL.  A rank that fails fails the phase."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit(dist_line("memory", free_gb=free / 1e9, total_gb=total / 1e9))
    refs = {}
    t = time.perf_counter()
    refs["rm2"] = rm2_reference(dev)
    t_ref = {"rm2": time.perf_counter() - t}
    t = time.perf_counter()
    refs["long"] = long_reference(dev)
    t_ref["long"] = time.perf_counter() - t
    t = time.perf_counter()
    refs["modules"] = modules_reference(dev)
    t_ref["modules"] = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ranks = spawn(dist_rank, DIST_RANKS, backend=DIST_BACKEND,
                      init_file=Path(tmp) / "init", device=dev.type,
                      args=(dev.type, bw, f32_rate, refs))
        ranks_s = time.perf_counter() - t
        t = time.perf_counter()
        nccl = spawn(nccl_rank, 1, backend=NCCL_BACKEND,
                     init_file=Path(tmp) / "init-nccl", device=dev.type,
                     args=(dev.type,))[0]
        nccl_s = time.perf_counter() - t
    rm2 = [r["rm2"] for r in ranks]
    long = [r["long"] for r in ranks]
    mods = [r["modules"] for r in ranks]
    res = {"phase": "dist", "ranks": DIST_RANKS, "backend": DIST_BACKEND,
           "one_card": True,
           "rm2": {"config": "dlrm-rm2 FULL, serve_p99 (batch 512), bf16 "
                             "table 130,000,384 x 64 over (data 1, model 2)",
                   "reference_table_gb": refs["rm2"]["table_gb"],
                   "reference_step_ms": refs["rm2"]["step_ms"],
                   "reference_s": t_ref["rm2"], "per_rank": rm2,
                   "launches": sum(r["launches"] for r in rm2)},
           "long_500k": {"config": "llama3.2-3b FULL, long_500k (B 1, S "
                                   "524,288, int8 cache) over (data 1, "
                                   "model 2): kv_seq = (data, model), the "
                                   "weights tensor-parallel over model",
                         "reference_cache_gb": refs["long"]["cache_gb"],
                         "reference_params_gb": refs["long"]["params_gb"],
                         "reference_peak_gb": refs["long"]["peak_gb"],
                         "reference_peak_gb_f32": refs["long"]["peak_gb_f32"],
                         "reference_step_ms": refs["long"]["step_ms"],
                         "reference_s": t_ref["long"], "per_rank": long,
                         "launches": sum(r["launches"] for r in long),
                         "params_gb_per_rank": [r["params_gb"]
                                                for r in long],
                         "step_peak_gb_per_rank": [r["step_peak_gb"]
                                                   for r in long],
                         "new_row_owners": sum(r["new_row_owner"]
                                               for r in long)},
           "modules": {"per_rank": mods, "reference_s": t_ref["modules"]},
           "nccl_world1": nccl, "ranks_s": ranks_s, "nccl_s": nccl_s}
    if res["long_500k"]["new_row_owners"] != 1:
        raise AssertionError("long_500k: the new row is not in exactly one "
                             "rank's shard")
    emit(dist_line("sharded_embedding", **res["rm2"]))
    emit(dist_line("seq_sharded_decode", **res["long_500k"]))
    emit(dist_line("dist_modules", **res["modules"]))
    emit({"phase": "dist", "stage": "nccl_world1", "ranks": 1,
          "one_card": True, **nccl})
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# the train and prefill cells on a mesh (dist_train)
# ---------------------------------------------------------------------------

DT_SEED = 41
DT_STEPS = 2            # (a)'s checked steps on the mesh
DT_CUT_ROWS = 3000      # (a)'s check copy: every vocabulary cut to this
DT_LM_LAYERS, DT_LM_BATCH = 4, 2    # (b) llama3.2-3b train_4k
DT_MOE_LAYERS, DT_MOE_BATCH = 2, 1  # (c) olmoe-1b-7b train_4k
DT_PREFILL_LAYERS = 2               # (d) llama3.2-3b prefill_32k, batch 1
DT_GNN_MESH = {"full_graph_sm": (1, DIST_RANKS),   # edges over both ranks
               "molecule": (DIST_RANKS, 1)}        # graphs over "data"


def dt_line(stage: str, **kw) -> dict:
    return {"phase": "dist_train", "stage": stage, "ranks": DIST_RANKS,
            "backend": DIST_BACKEND, "one_card": True, **kw}


def must_raise(name: str, fn) -> None:
    """``fn()`` (a check fed a planted fault) must raise AssertionError."""
    try:
        fn()
    except AssertionError:
        return
    raise AssertionError(f"{name}: a planted fault passed the check")


def leaf_checks(name: str, got: list, want: list, tol: float) -> float:
    """Each leaf against its reference at ``tol`` x the leaf's largest
    |want| (``check``); the largest error relative to that."""
    worst = 0.0
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} leaves, want {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        err = check(f"{name} leaf {i}", g, w, tol)
        worst = max(worst, err / max(float(w.float().abs().max()), 1e-30))
    return worst


@contextlib.contextmanager
def no_enter():
    """The planted fault of a missing ``collectives.enter``: every
    replicated input of a rank's partial work keeps its own gradient
    (the top-k weights, the tokens entering a column-parallel GEMM, the
    node states of a full-graph aggregate)."""
    from repro_torch.dist import collectives

    saved = collectives.enter
    collectives.enter = lambda x, group: x
    try:
        yield
    finally:
        collectives.enter = saved


@contextlib.contextmanager
def no_block_mean():
    """The planted fault of a block loss left the block's own mean."""
    from repro_torch.dist import collectives

    saved = collectives.block_mean
    collectives.block_mean = lambda x, axes: x
    try:
        yield
    finally:
        collectives.block_mean = saved


class LazyRefs:
    """The references of a rank, each loaded from its file when first
    used and dropped when the next is loaded."""

    def __init__(self, paths: dict):
        self.paths, self.key, self.value = paths, None, None

    def __getitem__(self, key):
        if key != self.key:
            self.value = None
            self.key, self.value = key, load_ref(self.paths[key])
        return self.value


def dt_mesh(shape, dev_type: str):
    from repro_torch.launch.mesh import Mesh

    return Mesh(shape, ("data", "model"), device_type=dev_type)


# --- (a) rm2 FULL train_batch, row-sharded --------------------------------


def window_touched(ids3, off, lo: int, hi: int, shift: int = 0):
    """The window's touched rows ``u`` (global, sorted) and the ids
    ``compact`` [B, F, P] that address them as rows 0 .. len(u) - 1 (the
    per-feature offsets folded in, so they go with zero offsets): a slot
    reads compact row i where its row is ``u[i] + shift``, none elsewhere.
    At shift 0 these are the window's pairs in the same order, since the
    compact rows keep the global rows' order."""
    import torch

    from repro_torch.kernels.embedding_bag import ref

    rows = ref.shift_feature_ids(ids3, off)
    u = torch.unique(rows[(rows >= lo) & (rows < hi)])
    pos = torch.searchsorted(u, rows - shift).clamp_max(max(u.numel() - 1, 0))
    hit = (rows >= 0) & (u.numel() > 0) & (u[pos] == rows - shift)
    return u, torch.where(hit, pos, -1).to(torch.int32)


BF16_UNIT = 2.0 ** -8   # bf16's unit roundoff: |bf16(x) - x| <= it x |x|


def ulp_held(name: str, got, want, pairs, abs_sum) -> float:
    """A bf16 table gradient's rows ``got`` per element against the float32
    plain version ``want`` of the same rows: |got - want| <= BF16_UNIT x
    |want| + 2**-22 x n x sum|terms|, n the row's pairs.  The kernel's
    compensated sum and the plain version's sum (any order) each lie
    within (n + 2) x 2**-24 x sum|terms| of the exact sum, and the kernel
    rounds once to bf16; so this bound holds for a right kernel, and a row
    missing or doubling one of few pairs misses it by far.  Returns the max
    abs error; raises past the bound, naming the worst row."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = (got.float() - want).abs()
    limit = BF16_UNIT * want.abs() + abs_sum * (
        pairs.to(torch.float32)[:, None] * 2.0 ** -22)
    over = err > limit
    if bool(over.any()):
        row = int(over.any(dim=1).nonzero()[0])
        raise AssertionError(
            f"{name}: {int(over.sum())} elements past one bf16 rounding of "
            f"the plain version, first in row {row} ({int(pairs[row])} "
            f"pairs), max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


@contextlib.contextmanager
def checked_window_grad(rank: int, errs: list):
    """Every call of K1's window backward held per element on the window's
    touched rows: bitwise against the unwindowed kernel launched on the
    same pairs (``window_touched``'s compact ids: the same pairs sorted in
    the same order and summed in the same chunks, so the same bits), and
    against the float32 plain version by ``ulp_held``; every other row
    exactly zero.  The ranks check one at a time (``solo``: the plain
    version's gather is ~9 GB a rank); the comparison launch is not
    counted.  The first call's check is also fed planted faults, each of
    which must fail ``ulp_held``: the window off by one row (each local row
    given the next global row's gradient), the pairs of every tenth bag
    dropped, and half the touched rows other than the hottest zeroed;
    the plain version rounded once to bf16 must pass it."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref

    saved = ops.embedding_bag_features_grad

    def wrapped(grad, ids, row_offsets, n_rows, *, row_window=None):
        got = saved(grad, ids, row_offsets, n_rows, row_window=row_window)
        if row_window is None:
            return got

        def one():
            lo, hi = row_window
            u, compact = window_touched(ids, row_offsets, lo, hi)
            zeros = torch.zeros_like(row_offsets)
            n_u, D = u.numel(), grad.shape[-1]
            name = f"k1 window backward call {len(errs)}"
            rows = got[u - lo]
            counted = ops.grad_launches
            twin = saved(grad, compact, zeros, n_u)
            ops.grad_launches = counted
            if not torch.equal(rows, twin):
                raise AssertionError(
                    f"{name}: {int((rows != twin).sum())} elements differ "
                    f"from the unwindowed kernel on the window's pairs")
            del twin
            g32 = grad.float()
            want = ref.embedding_bag_features_grad_ref(g32, compact, zeros,
                                                       n_u)
            abs_sum = ref.embedding_bag_features_grad_ref(
                g32.abs(), compact, zeros, n_u)
            live = compact[compact >= 0].long()
            pairs = torch.bincount(live, minlength=n_u)
            err = ulp_held(name, rows, want, pairs, abs_sum)
            line = {"max_abs_err": err, "bitwise_unwindowed_twin": True,
                    "touched_rows": n_u, "pairs": int(live.numel()),
                    "hot_row_pairs": int(pairs.max()) if n_u else 0,
                    "median_row_pairs": int(pairs.median()) if n_u else 0}
            del live
            if not errs:
                ulp_held(f"{name}, the plain version rounded once",
                         want.to(grad.dtype), want, pairs, abs_sum)
                faults = {}
                faults["the window off by one row"] = \
                    ref.embedding_bag_features_grad_ref(
                        g32, window_touched(ids, row_offsets, lo, hi, 1)[1],
                        zeros, n_u).to(grad.dtype)
                tenth = g32.clone()
                tenth.view(-1, D)[::10] = 0
                faults["every tenth bag's pairs dropped"] = \
                    ref.embedding_bag_features_grad_ref(
                        tenth, compact, zeros, n_u).to(grad.dtype)
                del tenth
                half = rows.clone()
                cold = (pairs < pairs.max()) & (
                    torch.arange(n_u, device=rows.device) % 2 == 0)
                half[cold] = 0
                faults["half the touched rows but the hottest zeroed"] = half
                for what, bad in faults.items():
                    must_raise(f"{name}, {what}", lambda bad=bad: ulp_held(
                        name, bad, want, pairs, abs_sum))
                line["planted_faults_failed"] = list(faults)
                del faults, half
            errs.append(line)
            rest = got.clone()
            rest[u - lo] = 0
            if bool(rest.any()):
                raise AssertionError(f"{name}: an untouched row is not 0")
            del rest, rows, want, abs_sum, pairs, g32, compact, u
            torch.cuda.empty_cache()
        solo(rank, one)
        return got

    ops.embedding_bag_features_grad = wrapped
    try:
        yield
    finally:
        ops.embedding_bag_features_grad = saved


def rm2_window_times(rank, g, ids, off, lo: int, hi: int, bw: float,
                     f32_rate: float) -> dict:
    """K1's window backward at the step's launch (``g`` a random bf16
    cotangent), its plain version (dense float32 ``index_add_``), the
    library (``torch.autograd.grad`` through ``F.embedding_bag`` on a table
    of the window's rows, ids outside it dropped) and the bound: the
    cotangent and ids read once, the window's rows written once; one rank
    at a time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops, ref

    R, D = hi - lo, g.shape[-1]
    rows = ref.shift_feature_ids(ids, off).reshape(-1, ids.shape[-1])
    keep = (rows >= lo) & (rows < hi)
    live = int(keep.sum())
    n_bytes = (g.numel() * g.element_size() + ids.numel() * 4
               + R * D * g.element_size())
    t_bytes, t_ops = n_bytes / bw * 1e3, live * D / f32_rate * 1e3

    def timed():
        def entry():
            return ops.embedding_bag_features_grad(g, ids, off, R,
                                                   row_window=(lo, hi))
        settle()
        ms = time_ms(entry, reps=GRAD_REPS)
        flat_ids = rows[keep] - lo
        bag_off = torch.zeros(rows.shape[0], dtype=torch.long, device=g.device)
        bag_off[1:] = keep.sum(dim=1).cumsum(0)[:-1]
        table = torch.zeros((R, D), dtype=g.dtype, device=g.device,
                            requires_grad=True)
        pooled = F.embedding_bag(flat_ids, table, bag_off, mode="sum")
        settle()
        library_ms = time_ms(lambda: torch.autograd.grad(
            pooled, table, g.reshape(-1, D), retain_graph=True),
            reps=GRAD_REPS)
        del table, pooled, flat_ids, bag_off
        torch.cuda.empty_cache()
        settle()
        plain_ms = time_ms(lambda: ref.embedding_bag_features_grad_ref(
            g, ids, off, R, (lo, hi)), reps=GRAD_REPS)
        torch.cuda.empty_cache()
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}

    out = solo(rank, timed)
    bound = max(t_bytes, t_ops)
    return {**out, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "live_pairs": live,
            "share_of_bound": bound / out["ms"]}


def rm2_cut_check(rank, mesh, dev, cell, batch_np) -> dict:
    """(a)'s correctness at every width: a copy of the cell with each
    vocabulary cut to DT_CUT_ROWS rows, on the mesh and on one device from
    the same seed and batch: the loss, the DenseNet's gradients, the rank's
    rows of the table gradient and, after one AdaGrad step, of the table
    and its accumulator; planted faults: the table's rows off by one."""
    import dataclasses

    import torch

    from repro_torch.common.tree import tree_leaves, tree_map_with_path
    from repro_torch.data.clicklog import cell_batch
    from repro_torch.dist import logical
    from repro_torch.dist.sharded_embedding import row_window
    from repro_torch.launch.steps import RECSYS_LR, recsys_train_cell

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_recsys_util import cut_vocab

    cut = cut_vocab(cell.cfg, DT_CUT_ROWS)
    mcell = dataclasses.replace(cell, cfg=cut)
    ocell = recsys_train_cell(cut, cell.batch, dev, lr=RECSYS_LR,
                              arch_id=cell.arch_id, shape=cell.shape)
    whole_np = cell_batch(cut, ocell.batch_specs, seed=DT_SEED + 2)
    whole = {k: torch.from_numpy(v).to(dev) for k, v in whole_np.items()}
    local = mcell.local_batch(whole)
    ms = mcell.init_state(torch.Generator(dev).manual_seed(DT_SEED + 1))
    os_ = ocell.init_state(torch.Generator(dev).manual_seed(DT_SEED + 1))
    with logical.axis_rules(mesh, mcell.rules):
        lo, hi = row_window(ms["model"].table)
    mloss, mg = mcell.value_and_grad(ms, local)
    oloss, og = ocell.value_and_grad(os_, whole)
    m_leaves, o_leaves = tree_leaves(mg), tree_leaves(og)
    is_table = tree_leaves(tree_map_with_path(
        lambda path, _: "table" in path, mg))
    dense_m = [g for g, t in zip(m_leaves, is_table) if not t]
    dense_o = [g for g, t in zip(o_leaves, is_table) if not t]
    tg_m = next(g for g, t in zip(m_leaves, is_table) if t)
    tg_o = next(g for g, t in zip(o_leaves, is_table) if t)
    out = {"rows": [lo, hi], "table": list(os_["model"].table.shape),
           "loss": float(mloss), "loss_one_device": float(oloss),
           "loss_err": check("rm2 cut loss", mloss, oloss, BF16_TOL),
           "dense_err": leaf_checks("rm2 cut DenseNet gradient", dense_m,
                                    dense_o, BF16_TOL),
           "table_grad_err": check("rm2 cut table gradient rows", tg_m,
                                   tg_o[lo:hi], BF16_TOL),
           "table_grad_bitwise": bool(torch.equal(tg_m, tg_o[lo:hi]))}
    must_fail("rm2 cut table gradient rows, off by one row", tg_o[lo + 1:
              hi + 1] if hi < tg_o.shape[0] else tg_o[lo - 1:hi - 1],
              tg_o[lo:hi], BF16_TOL)
    mcell.run(ms, local)
    ocell.run(os_, whole)
    m_table, o_table = ms["model"].table, os_["model"].table
    out["rows_after_err"] = check("rm2 cut rows after the step",
                                  m_table, o_table[lo:hi], BF16_TOL)
    out["rows_after_bitwise"] = bool(torch.equal(m_table, o_table[lo:hi]))
    must_fail("rm2 cut rows after the step, off by one row",
              o_table[lo + 1:hi + 1] if hi < o_table.shape[0]
              else o_table[lo - 1:hi - 1], o_table[lo:hi], BF16_TOL)
    del ms, os_, mg, og, whole, local
    torch.cuda.empty_cache()
    return out


def rm2_train_rank(rank: int, mesh, dev, bw: float, f32_rate: float) -> dict:
    """(a) on one rank: its 65,000,192 rows of rm2's bf16 table, DT_STEPS
    steps of the train cell on the mesh with every call of K1's window
    backward held to its plain version (counts from 0), one more step
    timed, K1's window backward timed alone, then the cut-vocabulary
    copy against one device."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.clicklog import cell_batch
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.sharded_embedding import row_window
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.embedding import routed_offsets

    t0 = time.perf_counter()
    cell = build_cell("dlrm-rm2", "train_batch", dev, mesh=mesh)
    one = build_cell("dlrm-rm2", "train_batch", dev)   # the whole batch
    batch_np = cell_batch(cell.cfg, one.batch_specs, seed=DT_SEED)
    m0 = mem()
    batch = cell.local_batch({k: torch.from_numpy(v).to(
        dev, one.batch_specs[k].dtype) for k, v in batch_np.items()})
    state = cell.init_state(torch.Generator(dev).manual_seed(DT_SEED))
    growth = mem() - m0
    args = list(batch.values()) + tree_leaves(state["model"].tree()) + \
        tree_leaves(state["opt"])
    table = state["model"].table
    with logical.axis_rules(mesh, cell.rules):
        lo, hi = row_window(table)
    build_s = time.perf_counter() - t0
    errs, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with checked_window_grad(rank, errs):
        ops.window_launches = ops.grad_window_launches = 0
        collectives.reset()
        for _ in range(DT_STEPS):
            state, out = cell.run(state, batch)
            losses.append(float(out["loss"]))
        torch.cuda.synchronize()
        launches = ops.window_launches
        grad_launches = ops.grad_window_launches
        calls = dict(collectives.calls)
    if launches < DT_STEPS or grad_launches < DT_STEPS:
        raise AssertionError("the sharded rm2 train cell did not launch "
                             "K1's window and its backward each step")
    # the checked steps' peak holds the checks' tensors; the timed step's
    # is the step's own
    peak_checked = torch.cuda.max_memory_allocated() / 1e9
    before = mem()
    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(lambda: cell.run(state, batch), reps=1, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_mem = mem_reading(growth, args, before, mem_peak())
    del args
    ids = batch["sparse_ids"].contiguous()
    off = routed_offsets(cell.cfg.embedding, dev)
    res = {"rank": rank, "coords": mesh.coords, "rows": [lo, hi],
           "table_gb": table.numel() * table.element_size() / 1e9,
           "batch": list(ids.shape), "build_s": build_s, "losses": losses,
           "window_launches": launches, "grad_window_launches": grad_launches,
           "collectives": calls, "grad_checks_per_call": errs,
           "grad_tolerance": "bitwise the unwindowed kernel on the "
                             "window's pairs; one bf16 rounding of the "
                             "float32 plain version (ulp_held)",
           "step_ms": step_ms, "peak_gb": peak, "memory": step_mem,
           "peak_gb_checked_steps": peak_checked,
           "all_reduce_bytes": ids.shape[0] * ids.shape[1] * table.shape[1] * 4}
    del state, table
    torch.cuda.empty_cache()
    g = torch.empty((*ids.shape[:2], cell.cfg.embedding.dim),
                    device=dev).normal_(
        generator=torch.Generator(dev).manual_seed(DT_SEED + rank)).to(
        torch.bfloat16)
    res.update(rm2_window_times(rank, g, ids, off, lo, hi, bw, f32_rate))
    del g, ids, batch
    torch.cuda.empty_cache()
    res["cut_check"] = rm2_cut_check(rank, mesh, dev, cell, batch_np)
    return res


# --- (b), (c) the LM train cells: tensor and expert parallel --------------


def lm_train_cell(dev, arch_id: str, layers: int, batch: int, dtype,
                  mesh=None, seq_shard: bool = False):
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell

    over = None
    if seq_shard:  # the config build_cell takes on dev, sequence-parallel
        arch = get_arch(arch_id)
        over = dataclasses.replace(arch.SMOKE if dev.type == "cpu"
                                   else arch.FULL, seq_shard=True)
    cell = build_cell(arch_id, "train_4k", dev, batch=batch, n_layers=layers,
                      mesh=mesh, cfg_override=over)
    # the dtype only sets the parameters' (the forward computes in theirs)
    return dataclasses.replace(cell, cfg=dataclasses.replace(cell.cfg,
                                                             dtype=dtype))


def lm_train_reference(dev, arch_id: str, layers: int, batch: int, dtype,
                       seed: int) -> dict:
    """One device's loss and gradients (on the host) of the cell at this
    cut, its gradient pass and step on the host clock and its peak."""
    import torch

    from repro_torch.common.tree import tree_leaves

    cell = lm_train_cell(dev, arch_id, layers, batch, dtype)
    state = cell.init_state(torch.Generator(dev).manual_seed(seed))
    tokens = torch.randint(0, cell.cfg.vocab, (batch, cell.seq_len),
                           generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    b = {"tokens": tokens.to(dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = cell.value_and_grad(state, b)
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    out = {"tokens": tokens, "seed": seed, "loss": loss.cpu(),
           "grads": [t.cpu() for t in tree_leaves(grads)],
           "grad_ms": grad_ms}
    del grads
    out["step_ms"] = host_ms(lambda: cell.run(state, b), reps=1, warmup=0)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["params_gb"] = tree_gb(state["params"])
    del state, b
    torch.cuda.empty_cache()
    return out


def load_ref(path: str):
    """A reference the parent saved (``phase_dist_train``), on the host."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def lm_train_rank(rank: int, mesh, dev, ref: dict, arch_id: str,
                  layers: int, batch: int, dtype, tol: float,
                  seq_shard: bool = False) -> dict:
    """(b), (c) or, with ``seq_shard``, (b') or (c') on one rank: its block
    of the parameters (heads, FFN columns or experts, vocabulary rows)
    drawn as one device draws them, one gradient pass held leaf by leaf
    (this rank's block) and in loss to one device at ``tol``, the
    collectives counted from 0; the planted fault of a missing ``enter``
    must fail, or with ``seq_shard`` (the residual stream a rank's
    sequence block) the leaves replicated over "model" (the norms, a
    router) are also held alone, and leaving out their sum over "model"
    must fail; one step timed."""
    import dataclasses

    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import local_shard, param_spec_tree

    cell = lm_train_cell(dev, arch_id, layers, batch, dtype, mesh=mesh,
                         seq_shard=seq_shard)
    m0 = mem()
    state = cell.init_state(torch.Generator(dev).manual_seed(ref["seed"]))
    b = cell.local_batch({"tokens": ref["tokens"].to(dev)})
    growth = mem() - m0
    specs = tree_leaves(param_spec_tree(cell.kind, state["params"]))
    want = [local_shard(w, s, mesh).to(dev)
            for w, s in zip(ref["grads"], specs)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset()
    t0 = time.perf_counter()
    loss, grads = cell.value_and_grad(state, b)
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    calls = dict(collectives.calls)
    peak = torch.cuda.max_memory_allocated() / 1e9
    name = f"{arch_id} {dtype} on the mesh" + (", seq_shard" if seq_shard
                                               else "")
    loss_err = check(f"{name} loss", loss.cpu(), ref["loss"], tol)
    worst = leaf_checks(f"{name} gradient", tree_leaves(grads), want, tol)
    extra = {}
    if seq_shard:
        rep = [i for i, s in enumerate(specs) if "model" not in tuple(s)]
        pick = lambda leaves: [leaves[i] for i in rep]  # noqa: E731
        extra = {"replicated_leaves": len(rep),
                 "replicated_grad_err_relative_to_leaf_max": leaf_checks(
                     f"{name} replicated gradient",
                     pick(tree_leaves(grads)), pick(want), tol),
                 "grad_axes": cell.grad_axes}
        del grads
        fault = dataclasses.replace(cell, grad_axes=tuple(
            a for a in cell.grad_axes if a != "model"))
        _, bad = fault.value_and_grad(state, b)
        must_raise(f"{name}, the norms' sum over model left out",
                   lambda: leaf_checks(f"{name} replicated gradient",
                                       pick(tree_leaves(bad)), pick(want),
                                       tol))
    else:
        del grads
        with no_enter():
            _, bad = cell.value_and_grad(state, b)
        must_raise(f"{name}, a missing enter", lambda: leaf_checks(
            f"{name} gradient", tree_leaves(bad), want, tol))
    del bad, want
    torch.cuda.empty_cache()
    before = mem()
    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(lambda: cell.run(state, b), reps=1, warmup=0)
    step_mem = mem_reading(growth, tree_leaves(state) + [b["tokens"]], before,
                           mem_peak())
    res = {"rank": rank, "coords": mesh.coords, "loss": float(loss),
           "loss_one_device": float(ref["loss"]), "loss_err": loss_err,
           "grad_err_relative_to_leaf_max": worst, "tolerance": tol,
           "leaves": len(specs), "params_gb": tree_gb(state["params"]),
           "grad_ms": grad_ms, "step_ms": step_ms, "peak_gb": peak,
           "memory": step_mem, "collectives": calls, **extra}
    del state, b
    torch.cuda.empty_cache()
    return res


# --- (d) prefill_32k -------------------------------------------------------


def prefill_cell(dev, dtype, mesh=None):
    import dataclasses

    from repro_torch.launch.steps import build_cell

    cell = build_cell("llama3.2-3b", "prefill_32k", dev, batch=1,
                      n_layers=DT_PREFILL_LAYERS, mesh=mesh)
    # the dtype only sets the parameters' (the forward computes in theirs)
    return dataclasses.replace(cell, cfg=dataclasses.replace(cell.cfg,
                                                             dtype=dtype))


def prefill_reference(dev, seed: int) -> dict:
    """One device's prefill_32k at this cut, bf16 (the cell's dtype) and
    an f32 copy: each one's step on the host clock, last logits and
    cache."""
    import torch

    cell = prefill_cell(dev, torch.bfloat16)
    tokens = torch.randint(0, cell.cfg.vocab, (1, cell.seq_len),
                           generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    res = {"seed": seed, "tokens": tokens}
    for dtype in (torch.bfloat16, torch.float32):
        cell = prefill_cell(dev, dtype)
        params = cell.init_state(torch.Generator(dev).manual_seed(seed))
        b = {"tokens": tokens.to(dev)}
        out = cell.run(params, b)
        key = "f32" if dtype == torch.float32 else "bf16"
        res[key] = {"step_ms": host_ms(lambda: cell.run(params, b), reps=1,
                                       warmup=0),
                    "logits": out["logits"].cpu(),
                    "cache": {k: v.cpu() for k, v in out["cache"].items()}}
        del params, out, b
        torch.cuda.empty_cache()
    return res


def prefill_rank(rank: int, mesh, dev, ref: dict) -> dict:
    """(d) on one rank, the bf16 cell (its step on the host clock, its
    collectives counted from 0) and an f32 copy: each one's last logits
    (this rank's vocabulary slice) and its kv_heads of the int8 cache
    against one device's, bf16 at BF16_TOL (scales; codes within
    BF16_TOL x 127) and f32 at F32_PATH_TOL (scales; codes at most one
    apart); the planted fault of the row-parallel all-reduces left out
    must fail each."""
    import torch

    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.models import transformer as tf

    res = {"rank": rank}
    for dtype in (torch.bfloat16, torch.float32):
        key = "f32" if dtype == torch.float32 else "bf16"
        tol = F32_PATH_TOL if key == "f32" else BF16_TOL
        cell = prefill_cell(dev, dtype, mesh=mesh)
        params = cell.init_state(torch.Generator(dev).manual_seed(
            ref["seed"]))
        b = cell.local_batch({"tokens": ref["tokens"].to(dev)})
        collectives.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.run(params, b)
        torch.cuda.synchronize()
        line = {"step_ms": (time.perf_counter() - t0) * 1e3,
                "tolerance": tol}
        if key == "bf16":
            res.update(collectives=dict(collectives.calls),
                       logits=list(out["logits"].shape),
                       cache_k=list(out["cache"]["k"].shape))
        want_logits = local_shard(ref[key]["logits"], P("data", "model"),
                                  mesh)
        spec = P(None, "data", None, "model", None)
        want = local_shard(ref[key]["cache"],
                           {k: spec for k in ref[key]["cache"]}, mesh)
        got = {k: v.cpu() for k, v in out["cache"].items()}
        line["logits_err"] = check(f"prefill on the mesh, {key} last logits",
                                   out["logits"].cpu(), want_logits, tol)
        line["logits_differing"] = int((out["logits"].cpu()
                                        != want_logits).sum())
        codes = max(int((got[k].int() - want[k].int()).abs().max())
                    for k in ("k", "v"))
        # f32: a value at a rounding boundary moves one code; bf16 K/V move
        # by a few bf16 steps where a layer's input does: within BF16_TOL
        # of the row's largest entry, 127 codes
        limit = 1 if key == "f32" else int(BF16_TOL * 127)
        if codes > limit:
            raise AssertionError(f"prefill on the mesh, {key}: int8 cache "
                                 f"codes {codes} apart (at most {limit})")
        line["cache_codes_apart"], line["cache_codes_limit"] = codes, limit
        line["cache_codes_differing"] = sum(int((got[k] != want[k]).sum())
                                            for k in ("k", "v"))
        line["cache_scale_err"] = max(check(
            f"prefill on the mesh, {key} cache {k}", got[k], want[k], tol)
            for k in ("ks", "vs"))
        saved = tf._tp_sum
        tf._tp_sum = lambda x, group, seq=False: x
        try:
            bad = cell.run(params, b)["logits"].cpu()
        finally:
            tf._tp_sum = saved
        must_fail(f"prefill on the mesh, {key}, the row-parallel all-reduces "
                  f"left out", bad, want_logits, tol)
        res[key] = line
        del params, out, b, got, want
        torch.cuda.empty_cache()
    return res


# --- (e) GraphSAGE ---------------------------------------------------------


@contextlib.contextmanager
def gnn_dtype(shape: str, dtype):
    """GraphSAGE's ``shape`` cell built in ``dtype`` (its parameters and
    activations; ``softmax_ce`` stays f32)."""
    import dataclasses

    from repro_torch.configs import graphsage_reddit as sage

    saved = sage.SHAPE_CONFIGS[shape]
    sage.SHAPE_CONFIGS[shape] = dataclasses.replace(saved, dtype=dtype)
    try:
        yield
    finally:
        sage.SHAPE_CONFIGS[shape] = saved


@contextlib.contextmanager
def sage_relu(record: list | None = None, force: list | None = None):
    """GraphSAGE's ReLU watched: each layer's pre-activation signs (out >
    0, on the host) appended to ``record``; or, with ``force``, layer i's
    ReLU replaced by out x force[i] (the gradient of that activation
    pattern: ReLU's backward is 0 at out <= 0)."""
    import torch

    from repro_torch.models import gnn as gnn_lib

    saved = gnn_lib._sage_combine
    calls = [0]

    def combine(layer, h_self, h_agg, activate=True):
        out = saved(layer, h_self, h_agg, activate=False)
        if not activate:
            return out
        i, calls[0] = calls[0], calls[0] + 1
        if force is not None:
            return out * force[i % len(force)].to(out.device, out.dtype)
        if record is not None:
            record.append((out > 0).cpu())
        return torch.relu(out)

    gnn_lib._sage_combine = combine
    try:
        yield
    finally:
        gnn_lib._sage_combine = saved


def leaf_err(got: list, want: list) -> float:
    """The largest of each leaf's max |got - want| over its max |want|."""
    return max(float((g.double() - w.double()).abs().max())
               / max(float(w.double().abs().max()), 1e-300)
               for g, w in zip(got, want))


def sign_flips(a: list, b: list) -> int:
    return sum(int((x != y).sum()) for x, y in zip(a, b))


MATCHED_FACTOR = 4   # (e)'s f32 limit: this x one device's f32 error


def gnn_train_reference(dev, shape: str, seed: int) -> dict:
    """One device's loss and gradients (on the host) of a GraphSAGE cell in
    float64, its f32 gradient pass on the host clock, and the f32 witness:
    the f32 pass run twice (the two runs' difference relative to each
    leaf's largest entry, and their sign flips: ``index_add_``'s atomics
    sum in no fixed order), and each run's pre-activation signs against
    float64's (the flips) and gradients against float64's, both as they
    are and with float64 given that run's activation pattern (the matched
    error; the larger of the two runs' sets (e)'s f32 limit:
    MATCHED_FACTOR x it, at least F32_TOL)."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.graph import cell_batch as graph_batch
    from repro_torch.launch.steps import build_cell

    res = {"seed": seed}
    cells = {}
    for dtype in (torch.float32, torch.float64):
        with gnn_dtype(shape, dtype):
            cells[dtype] = build_cell("graphsage-reddit", shape, dev)
    cell = cells[torch.float32]
    state = cell.init_state(torch.Generator(dev).manual_seed(seed))
    batch_np = graph_batch(cell.cfg, cell.dims, seed=seed)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    res.update(batch=batch_np, dims=cell.dims, grad_ms=host_ms(
        lambda: cell.value_and_grad(state, b), reps=3))
    runs, masks = [], [[], []]
    for i in range(2):
        with sage_relu(record=masks[i]):
            runs.append([g.cpu() for g in tree_leaves(
                cell.value_and_grad(state, b)[1])])
    cell = cells[torch.float64]
    state = cell.init_state(torch.Generator(dev).manual_seed(seed))
    masks64 = []
    with sage_relu(record=masks64):
        loss, grads = cell.value_and_grad(state, b)
    res.update(loss=loss.cpu(), grads=[g.cpu() for g in tree_leaves(grads)])
    witness = []
    for g32, masks32 in zip(runs, masks):
        with sage_relu(force=masks32):
            matched = [g.cpu() for g in tree_leaves(
                cell.value_and_grad(state, b)[1])]
        witness.append({"sign_flips_f32_vs_f64": sign_flips(masks32, masks64),
                        "err_vs_f64": leaf_err(g32, res["grads"]),
                        "err_vs_f64_matched": leaf_err(g32, matched)})
    err = max(w["err_vs_f64_matched"] for w in witness)
    res["f32_witness"] = {
        "repeat_bitwise": all(torch.equal(x, y) for x, y in zip(*runs)),
        "repeat_err": leaf_err(runs[1], runs[0]),
        "repeat_sign_flips": sign_flips(*masks),
        "pre_activations": sum(m.numel() for m in masks64),
        "runs": witness,
        "mesh_limit": max(F32_TOL, MATCHED_FACTOR * err)}
    del state, b, grads, cells
    torch.cuda.empty_cache()
    return res


def gnn_train_rank(rank: int, mesh, dev, dev_type: str, refs: dict) -> dict:
    """(e) on one rank: full_graph_sm with its edges over both ranks and
    molecule with its graphs over "data", each on its mesh of
    DT_GNN_MESH.  The f32 cell (the timed one): its gradient pass on the
    host clock, then its gradients against the float64 mesh copy given
    the f32 pass's activation pattern, at one device's limit
    (``gnn_train_reference``'s ``mesh_limit``), its sign flips against the
    float64 copy's and its error against one device's float64 gradients
    as they are.  The float64 copy: loss and every gradient against one
    device's at F32_TOL x the leaf's largest entry.  Planted faults, each
    fed to both checks: a missing ``enter`` (the full graph's node
    states), a block's own mean for the global one (molecule)."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.dist import collectives
    from repro_torch.launch.steps import build_cell

    out = {}
    for shape, mesh_shape in DT_GNN_MESH.items():
        ref = refs[shape]
        if mesh_shape != tuple(mesh.shape.values()):
            mesh = dt_mesh(mesh_shape, dev_type)
        line = {"mesh": list(mesh_shape)}
        cells = {}
        for dtype in (torch.float32, torch.float64):
            with gnn_dtype(shape, dtype):
                cells[dtype] = build_cell("graphsage-reddit", shape, dev,
                                          mesh=mesh)
            if cells[dtype].dims != ref["dims"]:
                raise AssertionError(f"{shape}: the mesh cell's sizes "
                                     f"{cells[dtype].dims} are not one "
                                     f"device's")
        fault = no_enter if shape == "full_graph_sm" else no_block_mean
        b = cells[torch.float32].local_batch(
            {k: torch.from_numpy(v).to(dev) for k, v in ref["batch"].items()})
        line["batch"] = {k: list(v.shape) for k, v in b.items()}
        name = f"{shape} on the mesh {mesh_shape}"

        # float64: one device's gradients at F32_TOL
        cell = cells[torch.float64]
        state = cell.init_state(torch.Generator(dev).manual_seed(ref["seed"]))
        collectives.reset()
        masks64 = []
        with sage_relu(record=masks64):
            loss, grads = cell.value_and_grad(state, b)
        calls = dict(collectives.calls)
        want = [w.to(dev) for w in ref["grads"]]
        loss_err = check(f"{name}, float64 loss", loss.cpu(), ref["loss"],
                         F32_TOL)
        worst = leaf_checks(f"{name}, float64 gradient", tree_leaves(grads),
                            want, F32_TOL)
        with fault():
            _, bad = cell.value_and_grad(state, b)
        must_raise(f"{name}, float64, planted fault", lambda: leaf_checks(
            name, tree_leaves(bad), want, F32_TOL))
        line.update(loss=float(loss), loss_err=loss_err,
                    grad_err_relative_to_leaf_max=worst, tolerance=F32_TOL,
                    collectives=calls)

        # f32, the timed cell
        c32 = cells[torch.float32]
        s32 = c32.init_state(torch.Generator(dev).manual_seed(ref["seed"]))
        line["grad_ms"] = host_ms(lambda: c32.value_and_grad(s32, b), reps=3)
        masks32 = []
        with sage_relu(record=masks32):
            _, g32 = c32.value_and_grad(s32, b)
        g32 = tree_leaves(g32)
        with sage_relu(force=masks32):
            matched = tree_leaves(cell.value_and_grad(state, b)[1])
        limit = ref["f32_witness"]["mesh_limit"]
        f32_err = leaf_checks(f"{name}, f32 against float64 at its "
                              f"activation pattern", g32, matched, limit)
        with fault():
            _, bad = c32.value_and_grad(s32, b)
        must_raise(f"{name}, f32, planted fault", lambda: leaf_checks(
            name, tree_leaves(bad), matched, limit))
        line["f32"] = {"err_vs_f64_matched": f32_err, "limit": limit,
                       "sign_flips_vs_f64": sign_flips(masks32, masks64),
                       "err_vs_one_device_f64": leaf_err(g32, want),
                       "one_device": ref["f32_witness"]}
        out[shape] = line
        del cells, cell, c32, state, s32, b, want, matched, g32, grads, bad
    return out


def dist_train_rank(rank: int, dev_type: str, bw: float, f32_rate: float,
                    paths: dict) -> dict:
    """One rank of the dist_train phase: (a)-(d), (b') and (c') on a (1,
    DIST_RANKS) ("data", "model") mesh over the card, (e) on the meshes
    of DT_GNN_MESH; each reference loaded from the file ``paths``
    names."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh

    refs = LazyRefs(paths)

    dev = torch.device(dev_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_debug_mesh(1, DIST_RANKS, device_type=dev_type)
    out = {}
    for key, fn in (
            ("rm2", lambda: rm2_train_rank(rank, mesh, dev, bw, f32_rate)),
            ("llama_bf16", lambda: lm_train_rank(
                rank, mesh, dev, refs["llama_bf16"], "llama3.2-3b",
                DT_LM_LAYERS, DT_LM_BATCH, torch.bfloat16, BF16_TOL)),
            ("llama_seq_bf16", lambda: lm_train_rank(
                rank, mesh, dev, refs["llama_bf16"], "llama3.2-3b",
                DT_LM_LAYERS, DT_LM_BATCH, torch.bfloat16, BF16_TOL,
                seq_shard=True)),
            ("olmoe_f32", lambda: lm_train_rank(
                rank, mesh, dev, refs["olmoe_f32"], "olmoe-1b-7b",
                DT_MOE_LAYERS, DT_MOE_BATCH, torch.float32, SUM_TOL)),
            ("olmoe_seq_f32", lambda: lm_train_rank(
                rank, mesh, dev, refs["olmoe_f32"], "olmoe-1b-7b",
                DT_MOE_LAYERS, DT_MOE_BATCH, torch.float32, SUM_TOL,
                seq_shard=True)),
            ("prefill", lambda: prefill_rank(rank, mesh, dev,
                                             refs["prefill"])),
            ("gnn", lambda: gnn_train_rank(rank, mesh, dev, dev_type,
                                           refs["gnn"]))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        # each case as it ends, on stderr: what a later case's failure
        # would otherwise take with it
        print(json.dumps(dt_line(f"{key}_rank{rank}", **out[key]),
                         default=str), file=sys.stderr, flush=True)
    return out


def phase_dist_train(dev, bw: float, f32_rate: float) -> dict:
    """The train and prefill cells on a mesh: the single-device references
    first (each freed before the next), then DIST_RANKS rank processes on
    the card over gloo run (a) dlrm-rm2 FULL train_batch row-sharded, (b)
    llama3.2-3b FULL-width train_4k tensor-parallel in bf16 and (b') the
    same with ``seq_shard`` (the residual stream a rank's sequence block),
    (c) olmoe-1b-7b FULL-width train_4k expert- and tensor-parallel and
    (c') with ``seq_shard``, (d) llama3.2-3b prefill_32k and (e)
    GraphSAGE's full_graph_sm and molecule.  (b') and (c') are held to
    the one-device references of (b) and (c).  A rank that fails fails
    the phase."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    refs, t_ref = {}, {}
    sys.path.insert(0, str(ROOT / "tests"))   # torch_recsys_util, in (a)
    for key, fn in (
            ("llama_bf16", lambda: lm_train_reference(
                dev, "llama3.2-3b", DT_LM_LAYERS, DT_LM_BATCH, torch.bfloat16,
                DT_SEED + 11)),
            ("olmoe_f32", lambda: lm_train_reference(
                dev, "olmoe-1b-7b", DT_MOE_LAYERS, DT_MOE_BATCH,
                torch.float32, DT_SEED + 12)),
            ("prefill", lambda: prefill_reference(dev, DT_SEED + 13)),
            ("gnn", lambda: {s: gnn_train_reference(dev, s, DT_SEED + 14 + i)
                             for i, s in enumerate(DT_GNN_MESH)})):
        t = time.perf_counter()
        refs[key] = fn()
        t_ref[key] = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # the references go to the ranks through files: several GB of
        # gradients, more than a shared-memory segment may hold
        paths = {}
        for key, ref in refs.items():
            paths[key] = str(Path(tmp) / f"ref_{key}.pt")
            torch.save(ref, paths[key])
        t = time.perf_counter()
        ranks = spawn(dist_train_rank, DIST_RANKS, backend=DIST_BACKEND,
                      init_file=Path(tmp) / "init", device=dev.type,
                      args=(dev.type, bw, f32_rate, paths))
        ranks_s = time.perf_counter() - t
    rm2 = [r["rm2"] for r in ranks]
    res = {"phase": "dist_train", "ranks": DIST_RANKS,
           "backend": DIST_BACKEND, "one_card": True, "ranks_s": ranks_s,
           "reference_s": t_ref,
           "rm2": {"config": "dlrm-rm2 FULL train_batch (batch 65536), bf16 "
                             "table 130,000,384 x 64 over (data 1, model 2), "
                             f"{DT_STEPS} checked steps",
                   "per_rank": rm2,
                   "window_launches": sum(r["window_launches"] for r in rm2),
                   "grad_window_launches": sum(r["grad_window_launches"]
                                               for r in rm2)}}
    emit(dt_line("rm2_train", **res["rm2"]))
    llama = (f"llama3.2-3b FULL width, {DT_LM_LAYERS} layers, train_4k B "
             f"{DT_LM_BATCH} S 4096, bf16, (1, 2)")
    olmoe = (f"olmoe-1b-7b FULL width, {DT_MOE_LAYERS} layers, train_4k B "
             f"{DT_MOE_BATCH} S 4096, f32, (1, 2)")
    for key, ref_key, config in (
            ("llama_bf16", "llama_bf16", llama),
            ("llama_seq_bf16", "llama_bf16", llama + ", seq_shard"),
            ("olmoe_f32", "olmoe_f32", olmoe),
            ("olmoe_seq_f32", "olmoe_f32", olmoe + ", seq_shard")):
        ref = refs[ref_key]
        res[key] = {"config": config, "loss_one_device": float(ref["loss"]),
                    "one_device_grad_ms": ref["grad_ms"],
                    "one_device_step_ms": ref["step_ms"],
                    "one_device_peak_gb": ref["peak_gb"],
                    "params_gb": ref["params_gb"],
                    "per_rank": [r[key] for r in ranks]}
        if key != ref_key:  # beside the same cell without seq_shard
            res[key]["without_seq_shard"] = [
                {k: r[ref_key][k] for k in ("grad_ms", "step_ms", "peak_gb",
                                            "collectives")} for r in ranks]
        emit(dt_line(key, **res[key]))
    res["prefill"] = {"config": f"llama3.2-3b FULL, prefill_32k, "
                                f"{DT_PREFILL_LAYERS} layers, batch 1, (1, 2)"
                                f"; checked in bf16 and in an f32 copy",
                      "one_device_step_ms": refs["prefill"]["bf16"]["step_ms"],
                      "one_device_f32_step_ms": refs["prefill"]["f32"][
                          "step_ms"],
                      "per_rank": [r["prefill"] for r in ranks]}
    emit(dt_line("prefill", **res["prefill"]))
    res["gnn"] = {s: {"one_device_grad_ms": refs["gnn"][s]["grad_ms"],
                      "per_rank": [r["gnn"][s] for r in ranks]}
                  for s in DT_GNN_MESH}
    emit(dt_line("gnn", **res["gnn"]))
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# the dry run: every cell on the production meshes, the prediction against
# the card, and the uneven head split at full width
# ---------------------------------------------------------------------------

DRYRUN_BUDGET_S = 120      # (a)'s sweep of both meshes
DRYRUN_KEYS = ("arch", "shape", "mesh", "n_devices", "time_trace_s",
               "flops_per_device", "bytes_per_device",
               "collective_bytes_per_device", "collectives", "memory",
               "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck")
CARD_BYTES = 80e9          # one rank's card
ALLOC_ROUNDING = 512       # the caching allocator's block, bytes a tensor
# a block of the large pool keeps the rest of its segment unsplit when the
# rest is 1 MiB or less: allocated bytes past the request, a large tensor
LARGE_REMAINDER = 1 << 20
PEAK_TOL = 0.10            # (b): the predicted peak against the measured
# (b): the cells earlier phases ran, traced at the same cut: (arch, shape,
# build_cell's cuts, on the (data 1, model 2) mesh of dist_train)
DRYRUN_CELLS = {
    "lm_decode_32k": ("llama3.2-3b", "decode_32k", {"batch": DECODE_BATCH},
                      False),
    "lm_prefill_32k": ("llama3.2-3b", "prefill_32k",
                       {"batch": PREFILL_BATCH}, False),
    "lm_train_4k": ("llama3.2-3b", "train_4k", {"batch": LM_TRAIN_BATCH},
                    False),
    "rm2_train_batch": ("dlrm-rm2", "train_batch", {}, False),
    "ogb_products": ("graphsage-reddit", "ogb_products", {}, False),
    "dist_rm2_train_batch": ("dlrm-rm2", "train_batch", {}, True),
    "dist_lm_train_4k": ("llama3.2-3b", "train_4k",
                         {"batch": DT_LM_BATCH, "n_layers": DT_LM_LAYERS},
                         True),
    "dist_lm_seq_train_4k": ("llama3.2-3b", "train_4k",
                             {"batch": DT_LM_BATCH, "n_layers": DT_LM_LAYERS,
                              "seq_shard": True}, True),
    "dist_long_500k": ("llama3.2-3b", "long_500k", {"batch": 1}, True),
}
PREDICT = """
import dataclasses, json, sys
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import build_cell
cells, out, mesh = json.loads(sys.argv[1]), {}, None
for key, (arch, shape, cuts, on_mesh) in cells.items():
    if on_mesh and mesh is None:
        dryrun.fake_world(2)
        mesh = make_debug_mesh(1, 2, device_type="cpu")
    over = None
    if cuts.pop("seq_shard", False):
        over = dataclasses.replace(get_arch(arch).FULL, seq_shard=True)
    rec = dryrun.trace_cell(build_cell(arch, shape, "meta",
                                       mesh=mesh if on_mesh else None,
                                       cfg_override=over, **cuts))
    out[key] = rec["memory"]
print(json.dumps(out))
"""
# (a): deepseek-67b's train_4k and prefill_32k on both production meshes,
# with and without seq_shard (the 256-rank train_4k fits only with it)
SEQ_DRYRUN = """
import dataclasses, json
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
out = []
for mesh in ("single", "multi"):
    for shape in ("train_4k", "prefill_32k"):
        for seq in (False, True):
            cfg = dataclasses.replace(get_arch("deepseek-67b").FULL,
                                      seq_shard=seq)
            rec = dryrun.run_cell_dryrun("deepseek-67b", shape, mesh,
                                         save=False, verbose=False,
                                         cfg_override=cfg)
            out.append({"mesh": mesh, "shape": shape, "seq_shard": seq,
                        **{k: rec[k] for k in (
                            "n_devices", "collectives",
                            "collective_bytes_per_device", "t_collective_s",
                            "bottleneck", "time_trace_s")},
                        "argument_gb": rec["memory"]["argument_size_bytes"]
                        / 1e9,
                        "peak_gb": rec["memory"]["peak_memory_bytes"] / 1e9,
                        "temp_gb": rec["memory"]["temp_size_bytes"] / 1e9})
print(json.dumps(out))
"""
# (c): qwen2-7b at FULL width, 28 heads and 4 kv heads over 8 "model"
# ranks: a kv head on 2 ranks, 7 q heads padded to 8, 4 a rank; its
# train_4k at UNEVEN_BATCH, then its decode_32k at TP_DECODE_BATCH
UNEVEN_ARCH, UNEVEN_LAYERS, UNEVEN_BATCH, UNEVEN_RANKS = "qwen2-7b", 2, 1, 8
TP_DECODE_BATCH = 16   # decode_32k cut 128 -> 16: batch over data 1
UNEVEN_SEED = 61


def dryrun_line(stage: str, **kw) -> dict:
    return {"phase": "dryrun", "stage": stage, **kw}


def dryrun_sweep(tmp: Path) -> list[dict]:
    """(a) ``python -m repro_torch.launch.dryrun --all --mesh both`` in a
    process of its own (it starts a fake process group of 256, then 512
    ranks): it must end 0 within DRYRUN_BUDGET_S, with a record of every
    key for each cell.  One line a mesh."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh",
         "both", "--out", str(tmp)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=2 * DRYRUN_BUDGET_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the dry run ended {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    if seconds > DRYRUN_BUDGET_S:
        raise AssertionError(f"the dry run took {seconds} s, past its "
                             f"{DRYRUN_BUDGET_S} s")
    records = [json.loads(p.read_text()) for p in sorted(tmp.iterdir())]
    lines = []
    for mesh in ("single", "multi"):
        recs = [r for r in records if r["mesh"] == mesh]
        for r in recs:
            missing = [k for k in DRYRUN_KEYS if k not in r]
            if missing:
                raise AssertionError(f"{r['arch']} {r['shape']} {mesh}: no "
                                     f"{missing}")
        if len(recs) != len(records) // 2 or not recs:
            raise AssertionError(f"{len(recs)} records on {mesh}")
        over = [f"{r['arch']} {r['shape']}" for r in recs
                if r["memory"]["peak_memory_bytes"] > CARD_BYTES]
        lines.append(dryrun_line(
            "sweep", mesh=mesh, ranks=recs[0]["n_devices"], cells=len(recs),
            seconds=seconds, trace_s=sum(r["time_trace_s"] for r in recs),
            over_80gb_a_rank=over,
            bottlenecks={b: sum(r["bottleneck"] == b for r in recs)
                         for b in ("compute", "memory", "collective")},
            records=[{k: r[k] for k in (
                "arch", "shape", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck")} | {
                "argument_gb": r["memory"]["argument_size_bytes"] / 1e9,
                "peak_gb": r["memory"]["peak_memory_bytes"] / 1e9}
                for r in recs]))
    return lines


def start_predictions() -> subprocess.Popen:
    """The dry run's traces of DRYRUN_CELLS, in a process of its own (a
    fake world of 2 for the mesh cells), started to run beside (a)."""
    return subprocess.Popen(
        [sys.executable, "-c", PREDICT, json.dumps(DRYRUN_CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)))


def start_seq_dryrun() -> subprocess.Popen:
    """SEQ_DRYRUN in a process of its own (fake worlds of 256 and 512),
    started to run beside (a)."""
    return subprocess.Popen(
        [sys.executable, "-c", SEQ_DRYRUN], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)))


def seq_dryrun_line(proc: subprocess.Popen) -> dict:
    """(a)'s deepseek-67b line: each record of SEQ_DRYRUN; with seq_shard
    the arguments must be those without, and train_4k must fit a rank's
    CARD_BYTES on both meshes."""
    stdout, stderr = proc.communicate(timeout=2 * DRYRUN_BUDGET_S)
    if proc.returncode != 0:
        raise AssertionError(f"the seq_shard dry run failed:\n"
                             f"{stderr[-3000:]}")
    recs = json.loads(stdout.strip().splitlines()[-1])
    key = lambda r: (r["mesh"], r["shape"])  # noqa: E731
    plain = {key(r): r for r in recs if not r["seq_shard"]}
    for r in recs:
        if r["seq_shard"]:
            if r["argument_gb"] != plain[key(r)]["argument_gb"]:
                raise AssertionError(f"{key(r)}: seq_shard changed the "
                                     f"arguments")
            if r["shape"] == "train_4k" and r["peak_gb"] * 1e9 > CARD_BYTES:
                raise AssertionError(f"{key(r)}: {r['peak_gb']} GB a rank "
                                     f"with seq_shard")
    return dryrun_line("seq_shard", arch="deepseek-67b", records=recs)


def dryrun_against_card(predictions: subprocess.Popen,
                        readings: dict) -> dict:
    """(b) each cell an earlier phase ran, traced at its cut on one device
    or rank 0 of the (data 1, model 2) mesh (a process of its own, with a
    fake world of 2): the arguments within ALLOC_ROUNDING bytes a tensor
    of what making the state and batch added to the caching allocator's
    requested bytes, and of what it added to its allocated bytes within
    that and LARGE_REMAINDER a large tensor (a block's unsplit rest of its
    segment); the peak within PEAK_TOL of a step's measured allocated
    peak above its baseline.  ``predictions``: ``start_predictions()``'s
    process; ``readings``: each cell's ``mem_reading`` (one a rank on the
    mesh)."""
    stdout, stderr = predictions.communicate(timeout=300)
    if predictions.returncode != 0:
        raise AssertionError(f"the predictions failed:\n{stderr[-3000:]}")
    predicted = json.loads(stdout.strip().splitlines()[-1])
    res, misses = {}, []
    for key, got in readings.items():
        want = predicted[key]
        for i, m in enumerate(got if isinstance(got, list) else [got]):
            name = key if not isinstance(got, list) else f"{key} rank {i}"
            args = want["argument_size_bytes"]
            requested_err = args - m["args_requested_bytes"]
            allocated_err = args - m["args_growth_bytes"]
            requested_limit = ALLOC_ROUNDING * m["tensors"]
            allocated_limit = requested_limit + \
                LARGE_REMAINDER * m["large_tensors"]
            peak_err = (want["peak_memory_bytes"]
                        - m["peak_above_baseline_bytes"]) \
                / m["peak_above_baseline_bytes"]
            line = {"cell": name, "argument_bytes_predicted": args,
                    "argument_bytes_requested": m["args_requested_bytes"],
                    "argument_requested_err_bytes": requested_err,
                    "argument_requested_limit_bytes": requested_limit,
                    "argument_bytes_allocated": m["args_growth_bytes"],
                    "argument_allocated_err_bytes": allocated_err,
                    "argument_allocated_limit_bytes": allocated_limit,
                    "tensors": m["tensors"],
                    "large_tensors": m["large_tensors"],
                    "peak_bytes_predicted": want["peak_memory_bytes"],
                    "peak_bytes_measured": m["peak_above_baseline_bytes"],
                    "peak_err_relative": peak_err, "peak_limit": PEAK_TOL,
                    "peak_requested_bytes": m["peak_requested_bytes"],
                    "peak_requested_err_relative": (
                        want["peak_memory_bytes"] - m["peak_requested_bytes"])
                    / m["peak_requested_bytes"]}
            res[name] = line
            if abs(requested_err) > requested_limit:
                misses.append(f"{name}: arguments {requested_err} bytes off "
                              "the requested bytes")
            if abs(allocated_err) > allocated_limit:
                misses.append(f"{name}: arguments {allocated_err} bytes off "
                              "the allocated bytes")
            if abs(peak_err) > PEAK_TOL:
                misses.append(f"{name}: peak {peak_err:+.3f} off")
    emit(dryrun_line("against_card", cells=res, misses=misses))
    if misses:
        raise AssertionError(f"the dry run missed the card: {misses}")
    return res


def uneven_cell(dev, mesh=None):
    import torch

    return lm_train_cell(dev, UNEVEN_ARCH, UNEVEN_LAYERS, UNEVEN_BATCH,
                         torch.bfloat16, mesh=mesh)


@contextlib.contextmanager
def no_kv_sum():
    """The planted fault of a replicated kv head whose gradient is not
    summed over the ranks that share it (each keeps its own q heads'
    share)."""
    from repro_torch.launch import steps

    saved = steps.collectives
    steps.collectives = types.SimpleNamespace(
        **{**vars(saved), "all_reduce": lambda x, group: x})
    try:
        yield
    finally:
        steps.collectives = saved


def tp_decode_cell(dev, mesh=None):
    from repro_torch.launch.steps import build_cell

    return build_cell(UNEVEN_ARCH, "decode_32k", dev, batch=TP_DECODE_BATCH,
                      n_layers=UNEVEN_LAYERS, mesh=mesh)


def tp_decode_token(cfg, dev):
    import torch

    return torch.randint(0, cfg.vocab, (TP_DECODE_BATCH, 1), device=dev,
                         dtype=torch.int32, generator=torch.Generator(
                             dev).manual_seed(UNEVEN_SEED + 1))


def tp_decode_f32(cell, dev, rank=None):
    """(c)'s decode_32k parameters in f32 (this rank's block, drawn one
    rank at a time, on a mesh) and their config."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf_lib

    cfg32 = dataclasses.replace(cell.cfg, dtype=torch.float32)

    def draw():
        params = cell.local_params(tf_lib.init(
            cfg32, device=dev,
            generator=torch.Generator(dev).manual_seed(UNEVEN_SEED)))
        torch.cuda.empty_cache()
        return params

    return (draw() if rank is None else solo(rank, draw)), cfg32


def tp_decode_reference(dev) -> dict:
    """(c)'s decode_32k on one device: the weights and the random int8
    cache drawn from UNEVEN_SEED, one step's logits and host time; then
    the step in f32 on the same cache."""
    import torch

    from repro_torch.models import transformer as tf_lib

    cell = tp_decode_cell(dev)
    params = cell.init_state(torch.Generator(dev).manual_seed(UNEVEN_SEED))
    batch = {"token": tp_decode_token(cell.cfg, dev),
             "cache": long_cache(cell.cfg, cell.batch, cell.seq_len, 0,
                                 cell.seq_len, UNEVEN_SEED, dev)}
    logits = cell.run(params, batch)["logits"]
    out = {"logits": logits.cpu(), "params_gb": tree_gb(params),
           "step_ms": host_ms(lambda: cell.run(params, batch), reps=3)}
    del params, logits
    torch.cuda.empty_cache()
    params, cfg32 = tp_decode_f32(cell, dev)
    with torch.inference_mode():
        out["logits_f32"] = tf_lib.decode_step(
            params, batch["token"], batch["cache"], cell.seq_len - 1,
            cfg32)[0].cpu()
    del params, batch
    torch.cuda.empty_cache()
    return out


def tp_decode_rank(rank: int, mesh, dev) -> dict:
    """(c)'s decode_32k on one rank: its block of the weights (4 q slots,
    its kv head, an eighth of the FFN and the vocabulary) and its 4,096 of
    the 32,768 cache rows, every kv head, drawn as one device draws them;
    one step with K3's int8 partials and the collectives counted from 0,
    again with every partials call held to its plain version; then the
    step in f32, each partials call held at ATTN_F32_TOL.  Returns its
    vocabulary slices of both steps' logits for the parent's check."""
    import torch

    from repro_torch.dist import collectives, logical
    from repro_torch.dist.decode import seq_shard_index
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as tf_lib

    cell = tp_decode_cell(dev, mesh)
    cfg, S = cell.cfg, cell.seq_len
    s_loc = cell.batch_specs["cache"]["k"].shape[2]
    off = seq_shard_index(mesh, cell.rules["kv_seq"]) * s_loc
    params = cell.init_state(torch.Generator(dev).manual_seed(UNEVEN_SEED))
    batch = {"token": tp_decode_token(cfg, dev),
             "cache": long_cache(cfg, cell.batch, S, off, off + s_loc,
                                 UNEVEN_SEED, dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: one step, counts from 0
    ops.launches["flash_decode_int8_partials"] = 0
    collectives.reset()
    logits = cell.run(params, batch)["logits"]
    torch.cuda.synchronize()
    launches = ops.launches["flash_decode_int8_partials"]
    calls = dict(collectives.calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_calls = {"all_gather": 2 * cfg.n_layers,
                  "all_reduce": 2 * cfg.n_layers + 1,
                  "reduce_scatter": 0, "gather": 0}
    if launches != cfg.n_layers or calls != want_calls:
        raise AssertionError(f"{UNEVEN_ARCH} decode_32k rank {rank}: "
                             f"{launches} K3 partials and collectives "
                             f"{calls} for {cfg.n_layers} layers, not "
                             f"{want_calls}")
    errs = []
    with checked_int8_partials(errs, BF16_TOL):
        again = cell.run(params, batch)["logits"]
    if not bool(torch.equal(again, logits)):
        raise AssertionError(f"{UNEVEN_ARCH} decode_32k rank {rank}: the "
                             "checked step differs")
    step_ms = host_ms(lambda: cell.run(params, batch), reps=3)
    res = {"rows": [off, off + s_loc], "launches": launches,
           "collectives": calls, "k3_vs_plain_max_abs_err_per_call":
           max(errs), "k3_checked_calls": len(errs),
           "params_gb": tree_gb(params), "peak_gb": peak_gb,
           "step_ms": step_ms, "logits": logits.cpu()}
    del params, logits, again
    torch.cuda.empty_cache()
    params, cfg32 = tp_decode_f32(cell, dev, rank)
    errs32 = []
    with torch.inference_mode(), logical.axis_rules(mesh, cell.rules), \
            checked_int8_partials(errs32, ATTN_F32_TOL):
        res["logits_f32"] = tf_lib.decode_step(
            params, batch["token"], batch["cache"], S - 1, cfg32)[0].cpu()
    res["k3_vs_plain_max_abs_err_per_call_f32"] = max(errs32)
    del params, batch
    torch.cuda.empty_cache()
    return res


def uneven_rank(rank: int, dev_type: str, path: str) -> dict:
    """(c) on one rank: its block of qwen2-7b's parameters (its 4 q heads,
    padded ones zero, and its kv head, whole) drawn as one device draws
    them; one gradient pass held leaf by leaf to one device's gradients
    cut the same way (a padded head's exactly zero) and in loss, at
    BF16_TOL; the fault of an unsummed kv head must fail it; then one step,
    after which its padded heads and their moments must be exactly zero.
    Returns its kv leaves and moments for the parent's bitwise check."""
    import torch

    from repro_torch.common.tree import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import (local_shard, pad_mask,
                                           param_spec_tree)
    from repro_torch.launch.mesh import make_debug_mesh

    dev = torch.device(dev_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(1, UNEVEN_RANKS, device_type=dev_type)
    ref = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    cell = uneven_cell(dev, mesh)
    state = cell.init_state(torch.Generator(dev).manual_seed(ref["seed"]))
    b = cell.local_batch({"tokens": ref["tokens"].to(dev)})
    params = state["params"]
    whole = tree_unflatten(params, ref["grads"])
    want = [w.to(dev) for w in tree_leaves(local_shard(
        whole, param_spec_tree(cell.kind, whole), mesh,
        heads=(cell.heads, cell.cfg.head_dim)))]
    del whole
    name = f"{UNEVEN_ARCH} uneven rank {rank}"
    loss, grads = cell.value_and_grad(state, b)
    loss_err = check(f"{name} loss", loss.cpu(), ref["loss"], BF16_TOL)
    worst = leaf_checks(f"{name} gradient", tree_leaves(grads), want,
                        BF16_TOL)
    del grads
    with no_kv_sum():
        _, bad = cell.value_and_grad(state, b)
    must_raise(f"{name}, an unsummed kv head", lambda: leaf_checks(
        f"{name} gradient", tree_leaves(bad), want, BF16_TOL))
    del bad, want
    state, _ = cell.run(state, b)
    i = mesh.axis_index("model")
    attn = state["params"]["blocks"]["attn"]
    padded = 0
    for key, t in attn.items():
        pad = pad_mask(["blocks", "attn", key], cell.heads, i,
                       cell.cfg.head_dim, t.dim())
        if pad is None:
            continue
        axis, mask = pad
        idx = torch.as_tensor(mask.nonzero()[0], device=dev)
        # a comprehension: no loop variable keeps a tree alive after it
        nonzero = [tname for tname, tree in (
            ("params", state["params"]), ("m", state["opt"]["m"]),
            ("v", state["opt"]["v"]))
            if tree["blocks"]["attn"][key].index_select(
                axis, idx).count_nonzero()]
        if nonzero:
            raise AssertionError(f"{name}: padded {key} {nonzero} not zero "
                                 f"after the step")
        if key == "wq":
            padded = int(mask.sum()) // cell.cfg.head_dim
    kv = {f"{tree}.{k}": t[k].cpu() for tree, t in (
        ("params", attn), ("m", state["opt"]["m"]["blocks"]["attn"]),
        ("v", state["opt"]["v"]["blocks"]["attn"]))
        for k in ("wk", "wv", "bk", "bv")}
    del state, b, params, attn, t
    torch.cuda.empty_cache()
    return {"rank": rank, "coords": mesh.coords, "share": cell.heads.share,
            "heads": [cell.cfg.n_heads, cell.cfg.n_kv_heads],
            "q_heads": cell.heads.q_heads(i),
            "kv_heads": cell.heads.kv_heads(i), "loss": float(loss),
            "loss_err": loss_err, "grad_err_relative_to_leaf_max": worst,
            "padded_heads": padded, "kv": kv,
            "decode": tp_decode_rank(rank, mesh, dev)}


def uneven_split(dev) -> dict:
    """(c) qwen2-7b train_4k at FULL width, UNEVEN_LAYERS layers, batch
    UNEVEN_BATCH, bf16 (row-parallel partials in f32), on UNEVEN_RANKS gloo
    ranks on the card, (data 1, model 8): one device's gradients first,
    handed to the ranks through a file; each rank's loss and gradient
    blocks at BF16_TOL; the padded heads zero after the step; each kv
    head's copies bitwise equal on the two ranks that hold it.  Then, in
    the same ranks, its tensor-parallel decode_32k at batch
    TP_DECODE_BATCH: the gathered logits against one device's step in f32
    at F32_PATH_TOL and in bf16 within BF16_TOL of the largest logit,
    every K3 partials call against its plain version, the collectives
    counted a layer."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    ref = lm_train_reference(dev, UNEVEN_ARCH, UNEVEN_LAYERS, UNEVEN_BATCH,
                             torch.bfloat16, UNEVEN_SEED)
    torch.cuda.empty_cache()
    dec = tp_decode_reference(dev)
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ref.pt")
        torch.save(ref, path)
        t = time.perf_counter()
        ranks = spawn(uneven_rank, UNEVEN_RANKS, backend=DIST_BACKEND,
                      init_file=Path(tmp) / "init", device=dev.type,
                      args=(dev.type, path))
        ranks_s = time.perf_counter() - t
    copies = 0
    by_head: dict = {}
    for r in ranks:
        by_head.setdefault(tuple(r["kv_heads"]), []).append(r)
    share = ranks[0]["share"]
    for head, rs in by_head.items():
        if len(rs) != share:
            raise AssertionError(f"kv head {head} on {len(rs)} ranks, not "
                                 f"{share}")
        for other in rs[1:]:
            for k, t in rs[0]["kv"].items():
                if not torch.equal(t, other["kv"][k]):
                    raise AssertionError(
                        f"kv head {head}: {k} differs between ranks "
                        f"{rs[0]['rank']} and {other['rank']}")
                copies += 1
    # each kv head's g q heads padded to a multiple of its ranks
    H, K = ranks[0]["heads"]
    g = H // K
    want_pads = K * (-(-g // share) * share - g)
    pads = [r["padded_heads"] for r in ranks]
    if sum(pads) != want_pads or want_pads != sum(
            h < 0 for r in ranks for h in r["q_heads"]):
        raise AssertionError(f"padded heads {pads} a rank, expected "
                             f"{want_pads} in all")
    per_rank = [{k: v for k, v in r.items() if k not in ("kv", "decode")}
                for r in ranks]
    line = dryrun_line(
        "uneven_split", config=f"{UNEVEN_ARCH} FULL width, {UNEVEN_LAYERS} "
        f"layers, train_4k B {UNEVEN_BATCH} S 4096, bf16, (data 1, model "
        f"{UNEVEN_RANKS}) gloo ranks on the card", tolerance=BF16_TOL,
        loss_one_device=float(ref["loss"]), one_device_grad_ms=ref["grad_ms"],
        reference_s=ref_s, ranks_s=ranks_s, kv_leaves_bitwise=copies,
        per_rank=per_rank)
    emit(line)
    # the decode: the ranks' vocabulary slices, in "model" order, against
    # one device's logits: in f32 at F32_PATH_TOL (the slices out of order
    # must fail), in bf16 within BF16_TOL of the largest logit (the bf16
    # path rounds its attention and partial sums elsewhere than one
    # device; K3 itself is held per call above)
    decode = [r["decode"] for r in sorted(ranks,
                                          key=lambda r: r["coords"]["model"])]
    whole, whole32 = (torch.cat([d.pop(k) for d in decode], dim=-1)
                      for k in ("logits", "logits_f32"))
    err32 = check(f"{UNEVEN_ARCH} decode_32k gathered f32 logits", whole32,
                  dec["logits_f32"], F32_PATH_TOL)
    n = whole32.shape[-1] // UNEVEN_RANKS
    must_fail(f"{UNEVEN_ARCH} decode_32k, the slices out of order",
              torch.cat([whole32[:, n:], whole32[:, :n]], dim=-1),
              dec["logits_f32"], F32_PATH_TOL)
    err = drift(whole, dec["logits"])
    scale = float(dec["logits"].float().abs().max())
    if err > BF16_TOL * scale:
        raise AssertionError(f"{UNEVEN_ARCH} decode_32k gathered bf16 "
                             f"logits: max abs err {err} past {BF16_TOL} x "
                             f"max |want| {scale}")
    past = int(((whole.float() - dec["logits"].float()).abs() > BF16_TOL + (
        BF16_TOL * dec["logits"].float().abs())).sum())
    dline = dryrun_line(
        "tp_decode", config=f"{UNEVEN_ARCH} FULL width, {UNEVEN_LAYERS} "
        f"layers, decode_32k B {TP_DECODE_BATCH} S 32768 int8 cache, bf16, "
        f"(data 1, model {UNEVEN_RANKS}): the weights tensor-parallel, the "
        f"cache's sequence over model, gloo ranks on the card",
        tolerance=BF16_TOL, logits_max_abs_err=err, logits_max_abs=scale,
        logits_past_elementwise_bf16_tol=past,
        logits_elements=whole.numel(), f32_logits_max_abs_err=err32,
        f32_tolerance=F32_PATH_TOL,
        k3_vs_plain_max_abs_err_per_call_f32=max(
            d["k3_vs_plain_max_abs_err_per_call_f32"] for d in decode),
        one_device_params_gb=dec["params_gb"],
        one_device_step_ms=dec["step_ms"],
        launches=sum(d["launches"] for d in decode),
        k3_vs_plain_max_abs_err_per_call=max(
            d["k3_vs_plain_max_abs_err_per_call"] for d in decode),
        per_rank=decode)
    emit(dline)
    line["tp_decode"] = dline
    return line


def phase_dryrun(dev, readings: dict) -> dict:
    """(a) the dry run of every cell on both production meshes, and of
    deepseek-67b's train_4k and prefill_32k with seq_shard beside it, (b)
    its prediction against what the earlier phases measured, (c) the
    uneven head split at full width on UNEVEN_RANKS ranks."""
    import tempfile

    t0 = time.perf_counter()
    predictions = start_predictions()
    seq = start_seq_dryrun()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            sweep = dryrun_sweep(Path(tmp))
        for line in sweep:
            emit(line)
        seq_line = seq_dryrun_line(seq)
        emit(seq_line)
        against = dryrun_against_card(predictions, readings)
    finally:
        for proc in (predictions, seq):
            if proc.poll() is None:   # (a) failed first
                proc.kill()
                proc.wait()
    res = {"phase": "dryrun",
           "sweep": [{k: v for k, v in line.items() if k != "records"}
                     for line in sweep],
           "seq_shard": [{k: r[k] for k in ("mesh", "shape", "seq_shard",
                                            "argument_gb", "peak_gb")}
                         for r in seq_line["records"]],
           "against_card": against, "uneven_split": uneven_split(dev)}
    res["seconds"] = time.perf_counter() - t0
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


def k4_day_streams(n_streams: int = 8, n: int = 150_000, k: int = 17,
                   seed: int = 4):
    """The longest chain of a full-width event-core day: 8 streams of
    150,000 jobs at k = 17, every other one with initial free times (as
    tests/test_torch_cuda.py's ``test_k4_full_width_day_shape`` builds
    them)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_streams):
        r = rng.exponential(0.2 / k, n).cumsum()
        d = rng.choice(rng.uniform(0.01, 0.8, 4), n)
        f0 = rng.uniform(0.0, 3.0, k) if i % 2 == 0 else None
        out.append((r, d, k, f0))
    return out


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
    every stream of every call for the duration; ``ops.launch`` (K4) timed
    with CUDA events (its device time) and the wide groups' packing, copies
    and unpacking on the host clock.  The checks' own time is kept apart in
    ``log["check_s"]``."""
    import torch

    from repro_torch.kernels.fleet_fifo import ops
    from repro_torch.serving import event_core

    finish, run_fleet, launch = (event_core.fleet_fifo_finish,
                                 event_core._run_fleet, ops.launch)
    events = []

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        events.append((start, end, args[2]))
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
    ops.launch = timed_launch
    try:
        yield log
    finally:
        event_core.fleet_fifo_finish = finish
        event_core._run_fleet = run_fleet
        ops.launch = launch
        torch.cuda.synchronize()
        ms = [(a.elapsed_time(b), int((off[1:] - off[:-1]).max()))
              for a, b, off in events]
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


def start_k4_probes():
    """nvcc of K4's source with ``tools/k4_bench.py``'s probes appended,
    started beside the kernels' build; returns (process, library)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import k4_bench
    from repro_torch.kernels import _build

    work = _build.BUILD_DIR / "k4_probes"
    lib = work / "k4_probes.so"
    cu = k4_bench.probe_source(_build.sources()["fleet_fifo"], work)
    return k4_bench.compile_k4(cu, lib), lib


def k4_floor_ns(probes, dev) -> dict[int, float]:
    """ns a step of each register instance with one busy lane on jobs
    already in shared memory (``k4_bench``'s ``k4_floor``)."""
    import ctypes

    import k4_bench

    proc, lib = probes
    k4_bench.finish(proc)
    return k4_bench.floor_ns(ctypes.CDLL(str(lib)), range(1, 33), dev,
                             time_ms)


def k4_case(name, streams, dev, bw: float, floor: dict, finish_reps=0):
    """K4 on ``streams`` through ``event_core.fleet_fifo_finish`` (one
    launch), bitwise ``_sweep`` on every stream with planted one-ulp faults,
    the launch's arguments held bitwise to K4's plain version (ends, and
    the state rows as the kernel writes them: sorted); the kernel alone
    timed, its ns a step, the byte bound and the kernel's step floor; with
    ``finish_reps``, ``fleet_fifo_finish`` against the sequential sweep on
    the host clock, interleaved best-of."""
    import numpy as np
    import torch

    from repro_torch.kernels.fleet_fifo import fleet_fifo_ref
    from repro_torch.kernels.fleet_fifo import ops
    from repro_torch.serving import event_core

    want = sweep_all(streams)
    packed = []
    launch = ops.launch
    ops.launch = lambda *a, **kw: packed.append(a) or launch(*a, **kw)
    try:
        got = event_core.fleet_fifo_finish(streams, device=dev)
    finally:
        ops.launch = launch
    if len(packed) != 1:
        raise AssertionError(f"{name}: {len(packed)} K4 launches, not 1")
    jobs = check_fleet(name, got, want)
    fleet_must_fail(name, got, want)
    args = packed[0]
    ready, dur, offsets, lanes, free0 = args
    lanes_np = lanes.cpu().numpy()
    ks = np.zeros(free0.shape[0], dtype=np.int64)
    ks[lanes_np[0][lanes_np[0] >= 0]] = lanes_np[1][lanes_np[0] >= 0]
    ends, state = ops.launch(*args)
    p_ends, p_state = fleet_fifo_ref(ready, dur, offsets, ks.tolist(), free0)
    torch.cuda.synchronize()
    if not torch.equal(ends, p_ends):
        raise AssertionError(f"{name}: K4 ends differ from its plain version")
    if not torch.equal(state, p_state):
        raise AssertionError(f"{name}: K4 end state differs from its plain "
                             "version")
    lens = np.diff(offsets.cpu().numpy())
    chain = int(lens.max())
    n_bytes = 24 * jobs + 16 * int(ks.sum())
    ms = time_ms(lambda: ops.launch(*args))
    step_floor_ms = max((n * floor[int(k)] for n, k in zip(lens, ks)
                         if int(k) in floor), default=0.0) / 1e6
    out = {
        "shape": f"{len(streams)} streams, k in {sorted(set(ks.tolist()))}, "
                 f"{jobs} jobs",
        "tolerance": "bitwise (ends and sorted end state, every stream, "
                     "against _sweep and the plain version)",
        "planted_faults_failed": 2,
        "ms": ms, "chain_steps": chain, "ns_per_step": ms * 1e6 / chain,
        "bound_ms": n_bytes / bw * 1e3, "bound_by": "bytes",
        "bytes": n_bytes, "share_of_bound": n_bytes / bw * 1e3 / ms,
        "step_floor_ms": step_floor_ms,
        "step_floor_of": "the kernel's own floor, not the card's: each "
                         "stream's length times its instance's ns a step "
                         "with one busy lane on jobs in shared memory "
                         "(k4_floor), the largest",
        "share_of_step_floor": step_floor_ms / ms,
        "library_ms": None, "max_abs_err": 0.0}
    if finish_reps:
        out["plain_ms"] = time_ms(
            lambda: fleet_fifo_ref(ready, dur, offsets, ks.tolist(), free0),
            reps=5)
        fin_s = sw_s = float("inf")
        for _ in range(finish_reps):  # interleaved, as bench_cluster's pair
            t0 = time.perf_counter()
            event_core.fleet_fifo_finish(streams, device=dev)
            fin_s = min(fin_s, time.perf_counter() - t0)
            t0 = time.perf_counter()
            sweep_all(streams)
            sw_s = min(sw_s, time.perf_counter() - t0)
        out["fleet_fifo_finish_ms"] = fin_s * 1e3
        out["sweep_ms"] = sw_s * 1e3
    return out


PROFILE_WORKERS = 8   # processes that profile the full-width day's pairs


def profile_one_pair(workload: str, server: str) -> None:
    """One (workload, server) pair of a table build, profiled as
    ``core.efficiency.build_table`` profiles it, into the profile cache."""
    from repro_torch.configs.paper_models import paper_profile
    from repro_torch.core.devices import SERVER_TYPES
    from repro_torch.core.efficiency import (TABLE_QPS_TOL,
                                             default_query_sizes,
                                             profile_pair)

    profile_pair(paper_profile(workload), SERVER_TYPES[server],
                 default_query_sizes(), seed=0, engine="fast",
                 use_cache=True, qps_tol=TABLE_QPS_TOL)


def profile_pairs(spec) -> float:
    """Profile every (workload, server) pair of ``spec``'s table in
    PROFILE_WORKERS processes at once, into the profile cache that its
    compile then reads (the same records, one pair a process call);
    returns the seconds."""
    import concurrent.futures
    import itertools
    import multiprocessing

    from repro_torch.core.devices import SERVER_TYPES

    servers = spec.servers or tuple(SERVER_TYPES)
    pairs = list(itertools.product(spec.workload_names(), servers))
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            PROFILE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(profile_one_pair, w, s) for w, s in pairs]:
            f.result()
    return time.perf_counter() - t0


def phase_cluster(dev, bw: float, probes) -> dict:
    """(a) K4 alone at bench_cluster's fleet shape and at a full-width
    day's longest chain, (b) the smoke event-core day (as it is, then with
    every k > 1 group wide), each bitwise the CPU day, (c) the full-width
    event-core day."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels.fleet_fifo import ops
    from repro_torch.serving import event_core
    from repro_torch.serving.scenarios import (compile_scenario, full_scale,
                                               get_scenario)

    res: dict = {"phase": "cluster"}
    # (a) K4 alone, at bench_cluster's fleet shape and at a full-width day's
    # longest chain
    floor = k4_floor_ns(probes, dev)
    res["a_fleet_bench"] = k4_case("fleet bench", fleet_bench_streams(), dev,
                                   bw, floor, finish_reps=5)
    res["a_day_shape"] = k4_case("day shape", k4_day_streams(), dev, bw,
                                 floor)
    res["a_floor_ns_per_step"] = floor

    # every pair of the full-width day's table (the smoke day's among them)
    # profiled at once into the profile cache, which the compiles then read
    full = full_scale(get_scenario("baseline_day"), n_steps=FULL_STEPS)
    profile_s = profile_pairs(full)

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
        "profile_s": profile_s, "profile_workers": PROFILE_WORKERS,
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
                   lm: dict, lm_configs: dict, recsys: dict, train: dict,
                   trainer: dict, dist: dict, dist_train: dict,
                   dryrun: dict, cluster: dict, cells: dict) -> list[dict]:
    """The summary of every kernel: where it replaces a TPU kernel, its
    launches on the paths driven here, its error and its times."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import variant

    m = k1["rmc1"]
    tk = trainer["step_check"]["k1"]
    g = train["k1_grad"]["rm2"]
    i8 = k3["int8"]
    fb = cluster["a_fleet_bench"]
    w = dist["rm2"]["per_rank"]
    lg = dist["long_500k"]["per_rank"]
    tpd = dryrun["uneven_split"]["tp_decode"]
    dt = dist_train["rm2"]["per_rank"]
    day = cluster["a_day_shape"]
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
        "redesigned_in": 15,
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
                            ("rmc3_prod", k1["rmc3"]),
                            ("mt_wnd_deep", recsys["mt_wnd"]["k1"]["deep"]),
                            ("mt_wnd_wide", recsys["mt_wnd"]["k1"]["wide"]))},
        "recsys": {
            "launches": recsys["k1_launches"],
            "mt_wnd_launches": recsys["mt_wnd"]["k1_launches"],
            "cell_launches": {f"{c['arch']}/{c['shape']}": c["k1_launches"]
                              for c in recsys["cells"]},
            "launches_note": "the recsys phase, counted from 0 before each "
                             "path: mt-wnd served (two launches a fused "
                             "launch: the deep and the wide table) and one "
                             "run of each registry cell"},
        "train": {
            "launches": train["k1_launches"],
            "launches_note": "the train phase's recsys cells, counted from "
                             "0: a launch a K1 table a forward (3 steps, the "
                             "loss after them, one gradient timed alone)"},
        "trainer": {
            "launches": trainer["k1_launches"],
            "launches_note": "launch.train_dlrm through the Trainer, counted "
                             "from 0: a launch a step (run A 60, run B 45 "
                             "then 20 resumed)",
            "shape": f"table {tk['table'][0]}x{tk['table'][1]} "
                     f"{tk['dtype']}, {tk['bags']} bags x P={tk['P']}",
            "features_entry_ms": tk["features_entry_ms"],
            **{k: tk[k] for k in k1_keys if k != "ms_stream"}},
        "cells": {
            f"{c['arch']}/{c['shape']}": {
                "launches": c["k1_launches"],
                "launches_note": "one run of the bulk cell in phase cells, "
                                 "counted from 0: a launch a K1 table",
                "max_abs_err_scores_on_row_blocks": c["max_abs_err"],
                "alone": c["k1_alone"]}
            for c in cells["cells"] if c.get("k1_alone")},
    }, {
        "name": "embedding_bag_grad",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag_grad.cu",
        "replaces": "src/repro/models/embedding.py:138 (jax.grad of "
                    "embedding_bag_local: its take's scatter-add; the TPU "
                    "kernel hot_embedding_bag_pallas has no backward)",
        "launches": train["k1_grad_launches"],
        "launches_note": "the train phase's recsys cells, counted from 0: "
                         "a launch a K1 table a backward (3 steps and one "
                         "gradient timed alone: dlrm-rm2 4, wide-deep 8); "
                         "trainer_launches: launch.train_dlrm through the "
                         "Trainer, a launch a step (other_shapes."
                         "train_dlrm: its launch shape)",
        "trainer_launches": trainer["k1_grad_launches"],
        **{k: g[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by", "share_of_bound",
                             "algo_bytes_ms", "tolerance")},
        "bound_note": "bytes: the pooled gradient and the ids read once, "
                      "the dense gradient written once; algo_bytes_ms: the "
                      "sorted design's traffic, a pooled-gradient row read "
                      "for every valid pair",
        "library_of": "torch.autograd.grad through F.embedding_bag("
                      "mode='sum') on the same ids",
        "shape": f"table {g['table'][0]}x{g['table'][1]} bf16, ids "
                 f"{g['ids']} ({g['valid_pairs']} valid pairs, "
                 f"{g['touched_rows']} rows)",
        "stages": g["stages"],
        "other_shapes": {c: {k: line[k] for k in (
            "table", "ids", "ms", "max_abs_err", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "share_of_bound")}
            for c, line in (*((c, train["k1_grad"][c])
                              for c in ("rmc1", "deep", "wide")),
                            ("train_dlrm",
                             trainer["step_check"]["k1_grad"]))},
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
        "lm_configs": {
            arch_id: {"launches": c["k3_int8_launches"],
                      "launches_note": "one decode_32k step, counted from "
                                       "0: n_layers",
                      "group": c["group"],
                      "k3_vs_plain_max_abs_err_per_call":
                          c["k3_vs_plain_max_abs_err_per_call"],
                      **{k: c["k3_int8"][k] for k in (
                          "shape", "max_abs_err", "ms", "plain_ms",
                          "library_ms", "bound_ms", "bound_by",
                          "share_of_bound", "tolerance")}}
            for arch_id, c in lm_configs["cells"].items()},
        "long_500k": {
            c["arch"]: {"launches": c["k3_int8_launches"],
                        "launches_note": "one long_500k step in phase "
                                         "cells, counted from 0: n_layers",
                        "n_layers": c["n_layers"], "group": c["group"],
                        "k3_vs_plain_max_abs_err_per_call":
                            c["k3_vs_plain_max_abs_err_per_call"],
                        **{k: c["k3_int8"][k] for k in (
                            "shape", "max_abs_err", "ms", "plain_ms",
                            "library_ms", "bound_ms", "bound_by",
                            "share_of_bound", "tolerance")}}
            for c in cells["cells"] if c["shape"] == "long_500k"},
    }, {
        "name": "hot_embedding_bag.row_window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:43 "
                    "(the row-sharded lookup of "
                    "src/repro/dist/sharded_embedding.py:47)",
        "launches": dist["rm2"]["launches"],
        "launches_note": "the sharded rm2 serve_p99 cell, both ranks, "
                         "counted from 0: one launch a rank (its rows of "
                         "the table, f32 partials)",
        "max_abs_err": max(r["window_max_abs_err"] for r in w),
        **{k: w[0][k] for k in ("ms", "ms_cold_l2", "plain_ms", "library_ms",
                                "bound_ms", "bound_by")},
        "per_rank_ms": [r["ms"] for r in w],
        "library_of": "F.embedding_bag(mode='sum') on the window's ids "
                      "remapped to local rows",
        "shape": f"table shard {w[0]['rows'][1] - w[0]['rows'][0]}x64 bf16 "
                 f"(rows {w[0]['rows']}), ids [512, 26, 64] -> f32",
        "tolerance": F32_TOL,
        "ranks": DIST_RANKS, "backend": DIST_BACKEND, "one_card": True,
    }, {
        "name": "embedding_bag_grad.row_window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag_grad.cu",
        "replaces": "the autodiff of src/repro/models/embedding.py:138 "
                    "embedding_bag_local under the row-sharded binding of "
                    "src/repro/dist/sharded_embedding.py:47 (the Pallas "
                    "kernel src/repro/kernels/embedding_bag/embedding_bag.py"
                    ":43 has no backward)",
        "launches": dist_train["rm2"]["grad_window_launches"],
        "launches_note": f"the sharded rm2 train cell, both ranks, "
                         f"{DT_STEPS} steps counted from 0: one launch a "
                         f"step a rank (its rows of the table gradient)",
        "max_abs_err": max(c["max_abs_err"] for r in dt
                           for c in r["grad_checks_per_call"]),
        **{k: dt[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")},
        "per_rank_ms": [r["ms"] for r in dt],
        "library_of": "torch.autograd.grad through F.embedding_bag(mode="
                      "'sum') on a table of the window's rows, ids outside "
                      "it dropped",
        "shape": f"cotangent [{dt[0]['batch'][0]}, {dt[0]['batch'][1]}, 64] "
                 f"bf16, ids {dt[0]['batch']} int32 -> rows "
                 f"{dt[0]['rows']} ({dt[0]['rows'][1] - dt[0]['rows'][0]} "
                 f"x 64 bf16)",
        "tolerance": dt[0]["grad_tolerance"],
        "ranks": DIST_RANKS, "backend": DIST_BACKEND, "one_card": True,
    }, {
        "name": "flash_decode_int8.partials",
        "route": "cuda",
        "source": decode_src,
        "replaces": "src/repro/kernels/flash_attention/flash_decode.py:76 "
                    "(flash_decode_partials on a shard of the "
                    "sequence-sharded cache, src/repro/dist/decode.py:66)",
        "launches": dist["long_500k"]["launches"] + tpd["launches"],
        "launches_note": "the tensor-parallel decode steps on a mesh, each "
                         "counted from 0: one launch a layer a rank, over "
                         "all the heads",
        "launches_by_path": {
            "dist long_500k, llama3.2-3b, 2 ranks":
                dist["long_500k"]["launches"],
            f"dryrun (c) decode_32k, {UNEVEN_ARCH}, {UNEVEN_RANKS} ranks":
                tpd["launches"]},
        "max_abs_err": max([r["k3_vs_plain_max_abs_err_per_call"]
                            for r in lg]
                           + [tpd["k3_vs_plain_max_abs_err_per_call"]]),
        "ms": lg[0]["partials_ms"], "plain_ms": lg[0]["partials_plain_ms"],
        "bound_ms": lg[0]["bound_ms"], "bound_by": lg[0]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call attends over an int8 cache "
                        "with per-row scales",
        "per_rank_ms": [r["partials_ms"] for r in lg],
        "shape": f"q [1, 1, {HEADS}, {HEAD_DIM}] bf16, k/v slice [1, "
                 f"{lg[0]['rows'][1] - lg[0]['rows'][0]}, {KV_HEADS}, "
                 f"{HEAD_DIM}] int8 of 524288 rows",
        "tolerance": BF16_TOL,
        "ranks": DIST_RANKS, "backend": DIST_BACKEND, "one_card": True,
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
        "redesigned_in": 17,
        "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "library_note": "no PyTorch call computes the k-server FIFO "
                        "recurrence",
        "ns_per_step": fb["ns_per_step"], "chain_steps": fb["chain_steps"],
        "step_floor_ms": fb["step_floor_ms"],
        "share_of_step_floor": fb["share_of_step_floor"],
        "fleet_fifo_finish_ms": fb["fleet_fifo_finish_ms"],
        "sweep_ms": fb["sweep_ms"],
        "shape": fb["shape"], "tolerance": fb["tolerance"],
        "day_shape": {k: day[k] for k in (
            "shape", "ms", "chain_steps", "ns_per_step", "bound_ms",
            "share_of_bound", "step_floor_ms", "share_of_step_floor")},
    }]


# ---------------------------------------------------------------------------
# the port's static analysis, and the kernel entries no phase names
# ---------------------------------------------------------------------------


def phase_analysis() -> dict:
    """``repro_torch.analysis`` over the port's default roots (the package,
    this script and the port's tests) on this machine's Python: files,
    findings and suppressions by rule.  Any finding, or a file that does
    not parse, fails the run."""
    from collections import Counter

    from repro_torch.analysis import analyze_paths, default_roots

    t0 = time.perf_counter()
    report = analyze_paths(default_roots(ROOT))
    bad = [*report.errors, *report.findings]
    line = {"phase": "analysis", "python": sys.version.split()[0],
            "files": report.n_files,
            "findings": dict(Counter(f.rule for f in bad)),
            "suppressed": dict(Counter(f.rule for f in report.suppressed)),
            "kernel_entries": sorted(report.facts.kernel_entries),
            "seconds": time.perf_counter() - t0}
    emit(line)
    if bad:
        raise AssertionError("static analysis: "
                             + "; ".join(f.format() for f in bad))
    return line


def phase_entries(dev, cfg) -> dict:
    """The kernel entries no phase above calls by name (the analysis's
    ``kernel-not-on-card`` rule holds every entry to being named here and
    in tests/test_torch_cuda.py), each against its plain version on the
    card: (a) K1's 2-D backward ``hot_embedding_bag_grad`` at ``cfg``'s
    launch (dlrm-rmc1 prod: bags [10240, 80] over the 25,000,448 x 32 f32
    table; a random pooled gradient), against its plain version in
    float64, two launches bitwise equal, the next bag's gradient planted
    (must fail); (b) K4's host entry ``fleet_fifo_streams`` (the event
    core's) and its tensor entry ``fleet_fifo`` at
    benchmarks/bench_cluster.py's fleet shape, one launch each, bitwise
    ``_sweep`` on every stream and the same calls on the CPU."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.kernels.fleet_fifo import ops as k4

    res: dict = {"phase": "entries"}
    # (a) K1's 2-D backward at the rmc1 launch
    emb = cfg.embedding
    H = emb.total_rows
    ids = torch.from_numpy(shifted_ids(click_launches(cfg, [6])[0],
                                       emb.row_offsets)).to(dev)
    g = torch.empty((ids.shape[0], emb.dim), device=dev).normal_(
        generator=torch.Generator(dev).manual_seed(6))
    before = ops.grad_launches
    got = ops.hot_embedding_bag_grad(g, ids, H)
    same = bool(torch.equal(got, ops.hot_embedding_bag_grad(g, ids, H)))
    torch.cuda.synchronize()
    if ops.grad_launches - before != 2:
        raise AssertionError(f"K1's 2-D backward: {ops.grad_launches - before}"
                             " launches for 2 calls")
    if not same:
        raise AssertionError("K1's 2-D backward: two launches differ")
    want = ref.hot_embedding_bag_grad_ref(g.double(), ids, H)
    err = check("K1 2-D backward at rmc1", got, want, F32_TOL)
    must_fail("K1 2-D backward, the next bag's gradient",
              ref.hot_embedding_bag_grad_ref(g.roll(1, dims=0).double(),
                                             ids, H), want, F32_TOL)
    res["hot_embedding_bag_grad"] = {
        "table": [H, emb.dim], "dtype": "float32", "ids": list(ids.shape),
        "valid_pairs": int((ids >= 0).sum()), "max_abs_err": err,
        "tolerance": F32_TOL, "plain_dtype": "float64",
        "bitwise_repeat": same, "planted_faults_failed": 1}
    del got, want, g, ids
    torch.cuda.empty_cache()

    # (b) K4's host and tensor entries at the fleet shape
    streams = fleet_bench_streams()
    want = sweep_all(streams)
    ready, dur, ks, free0 = ([s[i] for s in streams] for i in range(4))
    before = k4.launches
    ends, state, offsets = k4.fleet_fifo_streams(ready, dur, ks, free0,
                                                 device=dev)
    n_streams = k4.launches - before
    jobs = check_fleet("fleet_fifo_streams", [
        (ends[offsets[j]:offsets[j + 1]], state[j, :ks[j]])
        for j in range(len(streams))], want)
    p_ends, p_state, p_offsets = k4.fleet_fifo_streams(ready, dur, ks, free0,
                                                       device="cpu")
    if not (np.array_equal(ends, p_ends) and np.array_equal(state, p_state)
            and np.array_equal(offsets, p_offsets)):
        raise AssertionError("fleet_fifo_streams on the card differs from "
                             "its plain version")
    f0 = np.full((len(streams), max(ks)), np.inf)
    for j, (k, f) in enumerate(zip(ks, free0)):
        f0[j, :k] = f
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.concatenate(ready), np.concatenate(dur), offsets.astype(np.int64),
        f0)]
    before = k4.launches
    t_ends, t_state = k4.fleet_fifo(*tensors[:3], ks, tensors[3])
    torch.cuda.synchronize()
    n_tensor = k4.launches - before
    if not (np.array_equal(t_ends.cpu().numpy(), p_ends)
            and np.array_equal(t_state.cpu().numpy(), p_state)):
        raise AssertionError("fleet_fifo on the card differs from its plain "
                             "version")
    if (n_streams, n_tensor) != (1, 1):
        raise AssertionError(f"K4's entries: {n_streams} and {n_tensor} "
                             "launches, not one each")
    res["fleet_fifo_streams_and_fleet_fifo"] = {
        "shape": f"{len(streams)} streams, k in {sorted(set(ks))}, {jobs} "
                 "jobs",
        "launches": [n_streams, n_tensor],
        "tolerance": "bitwise (ends and sorted end state, every stream, "
                     "against _sweep and the plain version)",
        "max_abs_err": 0.0}
    return res


# ---------------------------------------------------------------------------
# the registry's cells on one card
# ---------------------------------------------------------------------------

# Each registry cell (repro_torch.configs.registry's archs x their SHAPES)
# in the phase that first builds it on the card in this process, before
# phase ``cells``; each phase's builds are recorded (``record_cells``), so
# a phase that stops building its cell fails the run.  With CELL_CUTS and
# NOT_ON_ONE_CARD every registry cell is named exactly once
# (tests/test_torch_card_cells.py reads the three by AST).
CARD_CELLS = {
    "lm": [("llama3.2-3b", "prefill_32k"), ("llama3.2-3b", "decode_32k")],
    "lm_configs": [("qwen2-7b", "decode_32k"), ("deepseek-67b", "decode_32k"),
                   ("qwen2-moe-a2.7b", "decode_32k"),
                   ("olmoe-1b-7b", "decode_32k")],
    "lm_train": [("llama3.2-3b", "train_4k")],
    "recsys": [("wide-deep", "serve_p99"), ("din", "serve_p99"),
               ("mind", "serve_p99"), ("dlrm-rm2", "serve_p99"),
               ("din", "retrieval_cand"), ("mind", "retrieval_cand")],
    "train": [("dlrm-rm2", "train_batch"), ("wide-deep", "train_batch"),
              ("din", "train_batch"), ("mind", "train_batch"),
              ("graphsage-reddit", "ogb_products"),
              ("graphsage-reddit", "minibatch_lg"),
              ("graphsage-reddit", "full_graph_sm"),
              ("graphsage-reddit", "molecule")],
    "dist": [("llama3.2-3b", "long_500k")],
    "dist_train": [("olmoe-1b-7b", "train_4k")],
    "dryrun": [("qwen2-7b", "train_4k")],
}
# Phase ``cells``: every other cell one card holds, at FULL width, cut only
# as far as the 80 GB card forces (build_cell's batch= and n_layers=).  An
# LM cut is the deepest whose dry-run peak (``dryrun.trace_cell`` of the
# cut on ``meta``) stays within CUT_BUDGET, with one batch sequence (a
# layer more adds 2.49 GB to deepseek-67b's long_500k peak and 8.31 GB to
# its train_4k one; 3.43 and 7.26 GB to qwen2-moe-a2.7b's).
CELL_CUTS = {
    ("qwen2-7b", "long_500k"): {},
    ("deepseek-67b", "long_500k"): {"n_layers": 29},
    ("qwen2-moe-a2.7b", "long_500k"): {"n_layers": 21},
    ("olmoe-1b-7b", "long_500k"): {},
    ("deepseek-67b", "train_4k"): {"batch": 1, "n_layers": 4},
    ("qwen2-moe-a2.7b", "train_4k"): {"batch": 1, "n_layers": 8},
    ("wide-deep", "serve_bulk"): {},
    ("din", "serve_bulk"): {},
    ("mind", "serve_bulk"): {},
    ("dlrm-rm2", "serve_bulk"): {},
    ("wide-deep", "retrieval_cand"): {},
    ("dlrm-rm2", "retrieval_cand"): {},
}
# The cells no cut puts on one card: these families keep the naive
# attention (only llama3.2-3b chunks it), whose [B, KVH, g, T, T] scores
# at T = 32,768 are past 80 GB at one layer and batch 1 (the dry run's
# one-device peaks there: 304.2, 694.0, 175.5 and 174.3 GB).  They run
# only sharded over many cards (PERF.md section 5).
NOT_ON_ONE_CARD = {
    ("qwen2-7b", "prefill_32k"):
        "naive attention: [1, 4, 7, 32768, 32768] bf16 scores (60.1 GB), "
        "then their f32 softmax (120.3 GB), at one layer and batch 1",
    ("deepseek-67b", "prefill_32k"):
        "naive attention: [1, 8, 8, 32768, 32768] bf16 scores (137.4 GB) at "
        "one layer and batch 1",
    ("qwen2-moe-a2.7b", "prefill_32k"):
        "naive attention: [1, 16, 1, 32768, 32768] bf16 scores (34.4 GB), "
        "then their f32 softmax (68.7 GB), at one layer and batch 1",
    ("olmoe-1b-7b", "prefill_32k"):
        "naive attention: [1, 16, 1, 32768, 32768] bf16 scores (34.4 GB), "
        "then their f32 softmax (68.7 GB), at one layer and batch 1",
}
# Room a long_500k cut leaves beside its state for K3's per-call check:
# the plain version on CHECK_KV_HEADS kv heads (2.15 GB) and the copies of
# its planted faults
K3_CHECK_ROOM = 4e9
# Room a train_4k cut leaves for the caching allocator's free blocks inside
# its segments, which the dry run does not count: on the H100 (85.0 GB)
# qwen2-moe-a2.7b's 9-layer step, 76.67 GB predicted, ran out with 9.3 GB
# reserved but unallocated (a train cell's CPU check runs after its state
# is freed)
ALLOC_ROOM = 5e9
# the dry-run peak an LM cut may reach
CUT_BUDGET = {"long_500k": CARD_BYTES - K3_CHECK_ROOM,
              "train_4k": CARD_BYTES - ALLOC_ROOM}
# a train cell's f32 copy held to the CPU: one FULL-width layer, the
# vocabulary cut to CHECK_VOCAB rows, a sequence of this many tokens
LM_CELL_CHECK_SEQ = {"deepseek-67b": 256, "qwen2-moe-a2.7b": 512}
CHECK_VOCAB = 3000


def cell_prediction(arch: str, shape: str, cut: dict) -> int:
    """The dry run's one-device peak of a CELL_CUTS cell at its cut
    (``dryrun.trace_cell`` on ``meta``: no memory, about a second)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell

    rec = dryrun.trace_cell(build_cell(arch, shape, "meta", **cut))
    return rec["memory"]["peak_memory_bytes"]


BUILT: dict = {}      # phase -> {(arch, shape)} built on the card
_PHASE = ["setup"]    # the phase running now


def record_cells() -> None:
    """From now on, every cell this process builds on the card through
    ``repro_torch.launch.steps.build_cell`` (the script's phases import it
    when they run) is recorded in BUILT under the running phase."""
    from repro_torch.launch import steps

    real = steps.build_cell

    def build_cell(arch_id, shape_name, device="cuda", **kw):
        cell = real(arch_id, shape_name, device, **kw)
        if cell.device.type == "cuda":
            BUILT.setdefault(_PHASE[0], set()).add((arch_id, shape_name))
        return cell

    steps.build_cell = build_cell


def coverage_line() -> dict:
    """Every registry cell but NOT_ON_ONE_CARD's built on the card in this
    process, each phase's CARD_CELLS (and CELL_CUTS in ``cells``) among
    its builds; none of NOT_ON_ONE_CARD built.  Fails otherwise."""
    from repro_torch.configs.registry import get_arch, list_archs

    registry = {(a, s.name) for a in list_archs() for s in get_arch(a).SHAPES}
    built = set().union(*BUILT.values())
    owed = {**{p: set(c) for p, c in CARD_CELLS.items()},
            "cells": set(CELL_CUTS)}
    unbuilt = {p: sorted(f"{a} {s}" for a, s in c - BUILT.get(p, set()))
               for p, c in owed.items()}
    line = {"phase": "coverage", "registry_cells": len(registry),
            "built_on_card": len(registry & built),
            "by_phase": {p: sorted(f"{a} {s}" for a, s in c)
                         for p, c in BUILT.items()},
            "not_on_one_card": {f"{a} {s}": why for (a, s), why in
                                NOT_ON_ONE_CARD.items()},
            "missing": sorted(f"{a} {s}" for a, s in
                              registry - set(NOT_ON_ONE_CARD) - built),
            "missing_by_phase": {p: c for p, c in unbuilt.items() if c},
            "built_though_not_on_one_card": sorted(
                f"{a} {s}" for a, s in built & set(NOT_ON_ONE_CARD))}
    emit(line)
    if line["missing"] or line["missing_by_phase"] or \
            line["built_though_not_on_one_card"] or \
            len(registry) != line["built_on_card"] + len(NOT_ON_ONE_CARD):
        raise AssertionError("the registry's cells on the card: "
                             f"{line['missing']} missing, "
                             f"{line['missing_by_phase']} not built by their "
                             "phase, "
                             f"{line['built_though_not_on_one_card']} built "
                             "though listed in NOT_ON_ONE_CARD")
    return line


def phase_cells(dev, bw: float, f32_rate: float) -> dict:
    """CELL_CUTS' cells on the card through ``build_cell``, one line each
    (arch, shape, cut, ms, peak and the dry run's predicted peak, kernel
    launches, max error, tolerance and what it was held against): the
    long_500k steps (``lm_config_decode``: K3's int8 entry held to its
    plain version at every call, the new row written at pos only), the
    train_4k steps (``lm_train_steps``, then one FULL-width layer in f32
    against the CPU, ``lm_train_check``), the bulk recsys cells
    (``recsys_cell``: row blocks, K1 alone at each launch).  Each cell's
    step peak above what the card held before it is held to the dry run's
    prediction at PEAK_TOL."""
    import torch

    t0 = time.perf_counter()
    predicted = {c: cell_prediction(*c, cut) for c, cut in CELL_CUTS.items()}
    res = {"phase": "cells", "predict_s": time.perf_counter() - t0,
           "cells": []}
    misses = []
    for (arch_id, shape), cut in CELL_CUTS.items():
        t = time.perf_counter()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        if shape == "long_500k":
            line = lm_config_decode(dev, bw, arch_id, shape, cut.get("batch"),
                                    cut.get("n_layers"))
            line.update(kernel_launches={
                "flash_decode_int8": line["k3_int8_launches"]},
                checked_against="K3's plain version at every call",
                max_abs_err=line["k3_vs_plain_max_abs_err_per_call"],
                ms=line["step_ms"])
            step_peak = line["step_peak_gb"] * 1e9
        elif shape == "train_4k":
            line = lm_train_steps(dev, arch_id, cut["batch"],
                                  cut.get("n_layers"), profile=False)
            step_peak = line["peak_gb"] * 1e9
            seq = LM_CELL_CHECK_SEQ[arch_id]
            line["cpu_check"] = chk = lm_train_check(dev, arch_id, 1, seq,
                                                     CHECK_VOCAB)
            line.update(kernel_launches={}, ms=line["median_step_ms"],
                        checked_against=f"the CPU: {chk['config']}, "
                                        f"{seq} tokens",
                        max_abs_err=chk["max_abs_err_relative_to_leaf_max"],
                        tolerance=chk["tolerance"])
        else:
            line = recsys_cell(dev, arch_id, shape, bw, f32_rate)
            line["kernel_launches"] = {"embedding_bag": line["k1_launches"]}
            step_peak = line["peak_gb"] * 1e9
        measured = step_peak - base
        err = (predicted[arch_id, shape] - measured) / measured
        line.update(cut=cut,
                    peak_gb_predicted=predicted[arch_id, shape] / 1e9,
                    step_peak_gb_above_start=measured / 1e9,
                    peak_err_relative=err, peak_limit=PEAK_TOL,
                    seconds=time.perf_counter() - t)
        if abs(err) > PEAK_TOL:
            misses.append(f"{arch_id} {shape}: step peak {measured / 1e9:.2f}"
                          f" GB, the prediction {err:+.3f} off")
        res["cells"].append(line)
        emit({"phase": "cells", "stage": f"{arch_id} {shape}", **line})
    torch.cuda.empty_cache()
    if misses:
        raise AssertionError(f"the cells' peaks: {misses}")
    res["seconds"] = time.perf_counter() - t0
    return res


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

    # 0. the port's static analysis (any finding fails the run)
    analysis = phase_analysis()

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
    probes = start_k4_probes()
    with _build.build_lock():
        built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "built": v["built"],
                          "ptxas": [ln for ln in v["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for k, v in built.items()}})

    from repro_torch.configs import dlrm_rm2
    from repro_torch.configs.paper_models import rmc1, rmc3

    dev = torch.device("cuda")
    seconds = {"analysis": analysis["seconds"],
               "build": time.perf_counter() - t0}

    # every cell built on the card from here on is recorded by phase
    record_cells()

    def timed(name: str, fn):
        """``fn()``, its seconds kept in ``seconds`` and, where it returns
        a phase's line, in the line; the cells it builds recorded under
        ``name``."""
        _PHASE[0] = name
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        if isinstance(out, dict):
            out.setdefault("seconds", seconds[name])
        return out

    # 3. kernel
    k1 = timed("kernel", lambda: phase_kernel(dev, bw, f32_rate, rmc1(True),
                                              dlrm_rm2.FULL, rmc3(True)))

    # 4. serve (the DLRM path; the K1 count is reset inside, just before it)
    serve_line = timed("serve", lambda: phase_serve(dev, rmc1(True)))
    emit(serve_line)

    # 5-6. the attention kernels alone
    k3 = timed("decode_kernel", lambda: phase_decode_kernel(dev, bw))
    emit(k3)
    k2 = timed("attention_kernel", lambda: phase_attention_kernel(dev, bw))
    emit(k2)

    # 7. the LM path (K3's count is reset inside, just before each cell)
    lm = timed("lm", lambda: phase_lm(dev))
    emit(lm)

    # 8. the other LM families' decode_32k (K3's count reset inside, just
    # before each step), then llama3.2-3b's train_4k
    lm_configs = timed("lm_configs", lambda: phase_lm_configs(dev, bw))
    emit(lm_configs)
    lm_train = timed("lm_train", lambda: phase_lm_train(dev))
    emit(lm_train)

    # 9. the recsys slice (K1's count is reset inside, just before each path)
    recsys = timed("recsys", lambda: phase_recsys(dev, bw, f32_rate))
    emit(recsys)

    # 10. training (K1's counts are reset inside, just before the train
    # cells), then launch.train_dlrm through the checkpointing Trainer (K1's
    # counts reset inside, just before run A)
    train = timed("train", lambda: phase_train(dev, bw, f32_rate))
    emit(train)
    trainer = timed("trainer", lambda: phase_trainer(dev, bw, f32_rate))
    emit(trainer)

    # 11. the distributed layer: rank processes on the card (each rank's
    # counts are reset inside, just before its main path)
    dist = timed("dist", lambda: phase_dist(dev, bw, f32_rate))
    emit({k: dist[k] for k in ("phase", "ranks", "backend", "one_card",
                               "ranks_s", "nccl_s", "seconds")})

    # 12. the train and prefill cells on a mesh (each rank's counts are
    # reset inside, just before its main path)
    dist_train = timed("dist_train",
                       lambda: phase_dist_train(dev, bw, f32_rate))
    emit({k: dist_train[k] for k in ("phase", "ranks", "backend",
                                     "one_card", "ranks_s", "reference_s",
                                     "seconds")})

    # 13. the dry run of every cell on the production meshes, held to what
    # the phases above measured, and the uneven head split on 8 ranks
    readings = {
        "lm_decode_32k": lm["decode_32k"]["memory"],
        "lm_prefill_32k": lm["prefill_32k"]["memory"],
        "lm_train_4k": lm_train["memory"],
        "rm2_train_batch": next(c["memory"] for c in train["cells"]
                                if c["arch"] == "dlrm-rm2"),
        "ogb_products": next(c["memory"] for c in train["cells"]
                             if c["shape"] == "ogb_products"),
        "dist_rm2_train_batch": [r["memory"] for r in
                                 dist_train["rm2"]["per_rank"]],
        "dist_lm_train_4k": [r["memory"] for r in
                             dist_train["llama_bf16"]["per_rank"]],
        "dist_lm_seq_train_4k": [r["memory"] for r in
                                 dist_train["llama_seq_bf16"]["per_rank"]],
        "dist_long_500k": [r["memory"] for r in
                           dist["long_500k"]["per_rank"]]}
    dryrun = timed("dryrun", lambda: phase_dryrun(dev, readings))
    emit({k: dryrun[k] for k in ("phase", "sweep", "seconds")})

    # 14. the cluster day (K4's count is reset inside, just before each day)
    cluster = timed("cluster", lambda: phase_cluster(dev, bw, probes))
    emit(cluster)

    # 15. the kernel entries no phase above calls by name
    entries = timed("entries", lambda: phase_entries(dev, rmc1(True)))
    emit(entries)

    # 16. the registry's other cells one card holds (K1's and K3's counts
    # reset inside, just before each cell)
    cells = timed("cells", lambda: phase_cells(dev, bw, f32_rate))
    emit({k: cells[k] for k in ("phase", "seconds")} | {
        "cells": [f"{c['arch']} {c['shape']}" for c in cells["cells"]]})

    coverage_line()
    emit({"phase": "seconds", **seconds,
          "total": time.perf_counter() - t_start})
    emit({"kernels": kernel_entries(k1, serve_line, k2, k3, lm, lm_configs,
                                    recsys, train, trainer, dist, dist_train,
                                    dryrun, cluster, cells),
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
