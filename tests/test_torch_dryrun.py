"""The dry run (``repro_torch.launch.dryrun``): every cell traced on the
256- and 512-rank production meshes without a card.

- Arguments: for every cell on both meshes, rank 0's
  ``argument_size_bytes`` against the reference's build of the same cell
  (``repro.launch.steps.build_cell(..., mesh=make_production_mesh())`` on
  256 or 512 host devices, in a subprocess; built only, since its
  lowering fails under jax 0.9.0), summed from ``NamedSharding.
  shard_shape`` over its state and batch specs.  Equal, except where the
  port's layout differs by design, by bytes worked out here from the
  config: an LM's attention leaves by whole heads (``HeadSplit``: the
  kv heads replicated and the q heads padded where the 16 "model" ranks
  outnumber the kv heads, every cell of llama3.2-3b, qwen2-7b and
  deepseek-67b) where the reference splits flat columns.  A decode cell
  holds the same weight blocks as a train or prefill cell.  Every cell's
  peak fits one rank's 80 GB card but deepseek-67b's train_4k (both
  meshes) and prefill_32k (the 256-rank mesh).
- Flops: small configs traced on the ``meta`` device against an analytic
  count written out here (2·m·n·k a matmul, the kernel entries' formulas).
- Depth: an LM extrapolated from 1 and 2 layers against its full trace.
- Collectives: a step on 4 gloo ranks for real against the dry run's
  count on a fake world of 4.
- Kernel entries: each shape-only path gives its plain version's shapes
  and dtypes; the CLI writes a record with the reference's keys.
- Peak: a small LM step traced on the CPU against the CPU allocator's own
  peak (``torch.profiler``'s memory events), the softmax kernels' inner
  copies included; the copies as the card's kernel makes them on
  ``meta``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.common.types import ArchKind
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.dist.sharding import HeadSplit
from repro_torch.kernels import fake
from repro_torch.kernels.embedding_bag import ops as k1
from repro_torch.kernels.flash_attention import ops as k3
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_cell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
MESHES = ("single", "multi")
CELLS = [(a, s.name) for a in list_archs() for s in get_arch(a).SHAPES]
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "collectives",
            "memory", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck"}
CARD_BYTES = 80e9  # one rank's H100
MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes",
               "alias_size_bytes", "peak_memory_bytes",
               "generated_code_size_bytes"}

# every state leaf (path, whole shape, itemsize, rank 0's shard shape) and
# the batch's shard bytes of each reference cell on both production meshes
REFERENCE = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import warnings; warnings.filterwarnings("ignore")
    import jax, numpy as np
    from repro.launch.dryrun import all_cells
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_cell
    out = {}
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=kind == "multi")
        for arch, shape in all_cells():
            cell = build_cell(arch, shape, mesh=mesh,
                              multi_pod=kind == "multi")
            flat = jax.tree_util.tree_flatten_with_path(cell.state_specs)[0]
            shard = jax.tree.leaves(cell.state_shardings)
            leaves = [(jax.tree_util.keystr(p), list(l.shape),
                       np.dtype(l.dtype).itemsize,
                       list(s.shard_shape(l.shape)))
                      for (p, l), s in zip(flat, shard)]
            batch = sum(int(np.prod(s.shard_shape(l.shape)))
                        * np.dtype(l.dtype).itemsize for l, s in zip(
                            jax.tree.leaves(cell.batch_specs),
                            jax.tree.leaves(cell.batch_shardings)))
            out[f"{arch}|{shape}|{kind}"] = {"leaves": leaves,
                                             "batch": batch}
    json.dump(out, open(sys.argv[1], "w"))
""")


def _run(args, timeout=600, **kw):
    r = subprocess.run(args, capture_output=True, text=True, env=ENV,
                       timeout=timeout, cwd=REPO, **kw)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout[-4000:]}\nSTDERR:\n" \
                              f"{r.stderr[-4000:]}"
    return r


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port's records of every cell on both meshes (the CLI, its own
    process) and the reference's shard shapes (another), run at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    ref_path = tmp / "reference.json"
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(tmp / "records")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO)
    _run([sys.executable, "-c", REFERENCE, str(ref_path)])
    out, err = port.communicate(timeout=600)
    assert port.returncode == 0, f"{out[-4000:]}\n{err[-4000:]}"
    records = {}
    for f in (tmp / "records").iterdir():
        rec = json.loads(f.read_text())
        records[f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"] = rec
    return records, json.loads(ref_path.read_text()), out


def _names(keystr: str) -> list[str]:
    return [k.strip("'\"") for k in keystr.strip("[]").split("][")]


def _expected_arguments(arch_id: str, ref: dict) -> int:
    """Rank 0's state and batch bytes in the port's layout, from the
    reference's shards: an LM's attention leaves by whole heads (each
    leaf's whole heads over its head count, times rank 0's heads of the
    split over 16 "model" ranks), in every cell."""
    arch = get_arch(arch_id)
    lm = arch.KIND in (ArchKind.LM_DENSE, ArchKind.LM_MOE)
    total = ref["batch"]
    cfg = arch.FULL
    split = HeadSplit.of(cfg.name, cfg.n_heads, cfg.n_kv_heads, 16) \
        if lm else None
    for path, whole, itemsize, shard in ref["leaves"]:
        names = _names(path)
        if lm and "attn" in names and names[-1] in (
                "wq", "bq", "wo", "wk", "wv", "bk", "bv"):
            q = names[-1] in ("wq", "bq", "wo")
            heads, local = ((cfg.n_heads, split.q_local) if q
                            else (cfg.n_kv_heads, split.kv_local))
            total += math.prod(whole) // heads * local * itemsize
        else:
            total += math.prod(shard) * itemsize
    return total


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch_id,shape_name", CELLS)
def test_arguments_match_reference_shards(sweep, arch_id, shape_name, mesh):
    records, refs, _ = sweep
    rec = records[f"{arch_id}|{shape_name}|{mesh}"]
    ref = refs[f"{arch_id}|{shape_name}|{mesh}"]
    assert REF_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory"])
    assert rec["n_devices"] == (256 if mesh == "single" else 512)
    got = rec["memory"]["argument_size_bytes"]
    want = _expected_arguments(arch_id, ref)
    assert got == want
    reference = ref["batch"] + sum(math.prod(s) * i
                                   for _, _, i, s in ref["leaves"])
    uneven = arch_id in ("llama3.2-3b", "qwen2-7b", "deepseek-67b")
    # the replication and padding are all that differs, and only in those
    # archs' cells (train, prefill and decode alike)
    assert (got == reference) == (not uneven)
    peak = rec["memory"]["peak_memory_bytes"]
    assert peak >= got
    over = (arch_id, shape_name) == ("deepseek-67b", "train_4k") or (
        (arch_id, shape_name, mesh) == ("deepseek-67b", "prefill_32k",
                                        "single"))
    assert (peak > CARD_BYTES) == over, peak / 1e9
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_every_cell_traced_on_both_meshes(sweep):
    records, _, out = sweep
    assert len(records) == 2 * len(CELLS) == 80
    assert "All dry-run cells passed." in out
    for key, rec in records.items():
        arch = get_arch(rec["arch"])
        lm = arch.KIND in (ArchKind.LM_DENSE, ArchKind.LM_MOE)
        assert rec["depth"] == ("extrapolated from 1 and 2 layers" if lm
                                else "traced at full depth"), key
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["rank"] == 0


# ---------------------------------------------------------------------------
# flops against an analytic count
# ---------------------------------------------------------------------------


def _lm_cfg(**kw):
    return dataclasses.replace(get_arch("llama3.2-3b").SMOKE,
                               attn_impl="naive", **kw)


def _lm_layer(cfg, B: int, T: int, Tk: int) -> int:
    """One block's forward matmuls: q, k, v, o projections, scores and
    values over Tk keys, the SwiGLU."""
    d, hd, H, K = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * B * T * d * hd * (2 * H + 2 * K)
    return proj + 4 * B * H * T * Tk * hd + 3 * 2 * B * T * d * cfg.d_ff


def _trace(arch_id, shape_name, cfg):
    return dryrun.trace_cell(build_cell(arch_id, shape_name, "meta",
                                        cfg_override=cfg))


def test_lm_flops_match_analytic_count():
    """train: forward, backward (twice each matmul) and the remat
    recompute of each block, which stops before the block's last product
    (w_down: no saved tensor needs its output); prefill: every block and
    the head at the last position; decode: the blocks at one token and
    K3's 4·B·H·kv_len·hd at kv_len = S."""
    cfg = _lm_cfg()
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    B, S = 256, 4096                                   # train_4k
    block, head = _lm_layer(cfg, B, S, S), 2 * B * S * d * V
    down = 2 * B * S * cfg.d_ff * d
    rec = _trace("llama3.2-3b", "train_4k", cfg)
    assert rec["flops_per_device"] == 3 * (L * block + head) + L * (
        block - down)
    B, S = 32, 32768                                   # prefill_32k
    rec = _trace("llama3.2-3b", "prefill_32k", cfg)
    assert rec["flops_per_device"] == L * _lm_layer(cfg, B, S, S) + \
        2 * B * d * V
    B, S = 128, 32768                                  # decode_32k
    rec = _trace("llama3.2-3b", "decode_32k", cfg)
    k3_flops = 4 * B * cfg.n_heads * S * cfg.head_dim
    assert rec["kernels"]["k3"] == {
        "launches": L, "flops": L * k3_flops, "dtype": "float32",
        "bytes": rec["kernels"]["k3"]["bytes"]}
    layer_without_attn = _lm_layer(cfg, B, 1, 0)
    assert rec["flops_per_device"] == L * (layer_without_attn + k3_flops) \
        + 2 * B * d * V


def _dlrm_counts(cfg, B: int):
    """(bottom MLP products, interaction, top MLP products, K1 adds) of
    one forward: 2·B·in·out a layer, 2·B·n²·D the dot interaction."""
    emb = cfg.embedding
    bottom = [cfg.n_dense, *cfg.bottom_mlp]
    n = emb.num_features + 1
    top = [n * (n - 1) // 2 + cfg.embed_dim, *cfg.top_mlp, 1]
    def mm(sizes):
        return [2 * B * a * b for a, b in zip(sizes, sizes[1:])]

    return (mm(bottom), 2 * B * n * n * emb.dim, mm(top),
            B * emb.num_features * max(emb.pooling) * emb.dim)


def test_dlrm_flops_match_analytic_count():
    """serve: the MLPs, the interaction and K1's B·F·P·D adds; train: the
    backward takes each product twice more (the first bottom layer once:
    the dense input has no gradient) and K1's backward slots·D."""
    cfg = get_arch("dlrm-rm2").SMOKE
    B = 512                                            # serve_p99
    bottom, inter, top, bag = _dlrm_counts(cfg, B)
    rec = _trace("dlrm-rm2", "serve_p99", cfg)
    assert rec["flops_per_device"] == sum(bottom) + inter + sum(top) + bag
    assert rec["kernels"]["k1"]["flops"] == bag
    B = 65536                                          # train_batch
    bottom, inter, top, bag = _dlrm_counts(cfg, B)
    rec = _trace("dlrm-rm2", "train_batch", cfg)
    assert rec["flops_per_device"] == (2 * bottom[0] + 3 * sum(bottom[1:])
                                       + 3 * inter + 3 * sum(top) + 2 * bag)
    assert rec["kernels"]["k1_grad"] == {
        "launches": 1, "flops": bag, "dtype": "float32",
        "bytes": rec["kernels"]["k1_grad"]["bytes"]}


def test_gnn_flops_match_analytic_count():
    """molecule (128 graphs of 30 nodes): each layer's two products
    (self and neighbours), the classifier on the pooled graphs; the
    first layer's backward once more (its input features have no
    gradient), every other product twice."""
    cfg = dataclasses.replace(
        get_arch("graphsage-reddit").SHAPE_CONFIGS["molecule"], d_hidden=32)
    G, n = 128, 30
    N = G * n
    first = 2 * 2 * N * cfg.d_feat * cfg.d_hidden
    second = 2 * 2 * N * cfg.d_hidden * cfg.d_hidden
    cls = 2 * G * cfg.d_hidden * cfg.n_classes
    rec = _trace("graphsage-reddit", "molecule", cfg)
    assert rec["flops_per_device"] == 2 * first + 3 * second + 3 * cls


# ---------------------------------------------------------------------------
# the depth extrapolation and the collectives, on fake worlds
# ---------------------------------------------------------------------------


DEPTH = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_arch("llama3.2-3b").SMOKE, n_layers=4,
                              n_heads=8, n_kv_heads=2, attn_impl="chunked",
                              attn_chunk=512)
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        out[shape] = [dryrun.run_cell_dryrun(
            "llama3.2-3b", shape, "debug", save=False, verbose=False,
            cfg_override=cfg, full_depth=full) for full in (False, True)]
    json.dump(out, open(sys.argv[1], "w"))
""")
PEAK_TOL = 0.05  # the peak is not linear in depth, only nearly


@pytest.fixture(scope="module")
def depth(tmp_path_factory):
    path = tmp_path_factory.mktemp("depth") / "depth.json"
    _run([sys.executable, "-c", DEPTH, str(path)])
    return json.loads(path.read_text())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_depth_extrapolation_equals_full_trace(depth, shape):
    """4 layers (8 heads, 2 kv heads: a kv head on 2 of the debug mesh's 4
    "model" ranks) from 1 and 2 against all 4: flops, bytes, collective
    bytes and arguments exactly; the peak within PEAK_TOL."""
    ext, full = depth[shape]
    assert ext["depth"] == "extrapolated from 1 and 2 layers"
    assert full["depth"] == "traced at full depth"
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collectives",
                "flops_by_dtype"):
        assert ext[key] == full[key], key
    assert ext["memory"]["argument_size_bytes"] == \
        full["memory"]["argument_size_bytes"]
    assert ext["collective_bytes_per_device"] > 0
    peak = full["memory"]["peak_memory_bytes"]
    assert abs(ext["memory"]["peak_memory_bytes"] - peak) <= PEAK_TOL * peak


COLLECTIVE_CELLS = [
    ("llama3.2-3b", "train_4k", _lm_cfg(n_heads=6, n_kv_heads=2)),
    ("llama3.2-3b", "long_500k", _lm_cfg(n_heads=6, n_kv_heads=2,
                                         kv_quant="int8")),
    ("dlrm-rm2", "train_batch", get_arch("dlrm-rm2").SMOKE),
    ("graphsage-reddit", "full_graph_sm",
     dataclasses.replace(get_arch("graphsage-reddit").SMOKE, mode="full")),
]
FAKE = textwrap.dedent("""
    import json, pickle, sys
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell
    cells = pickle.load(open(sys.argv[1], "rb"))
    dryrun.fake_world(4)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    out = {f"{a}|{s}": dryrun.trace_cell(build_cell(
        a, s, "cpu", mesh=mesh, cfg_override=c))["collectives"]
        for a, s, c in cells}
    json.dump(out, open(sys.argv[2], "w"))
""")


def test_collectives_equal_a_real_run(tmp_path):
    """A step of each cell on 4 gloo ranks, (data 2, model 2): every
    rank's calls and bytes by kind are the dry run's on a fake world of
    4 for the same cell and mesh (an uneven LM's train step and its
    tensor-parallel decode, row-sharded DLRM, the full graph's gathered
    nodes)."""
    import pickle

    (tmp_path / "cells.pkl").write_bytes(pickle.dumps(COLLECTIVE_CELLS))
    _run([sys.executable, "-c", FAKE, str(tmp_path / "cells.pkl"),
          str(tmp_path / "fake.json")])
    dry = json.loads((tmp_path / "fake.json").read_text())
    real = spawn(ranks.collectives_rank, 4, backend="gloo",
                 init_file=tmp_path / "init", device="cpu",
                 args=(COLLECTIVE_CELLS,))
    for key, want in dry.items():
        assert want, key
        for r in real:
            got = {}
            for kind in ("all_reduce", "all_gather"):
                if r[key]["calls"][kind]:
                    k = kind.replace("_", "-")
                    got[k] = r[key]["nbytes"][kind]
                    got[k + "_count"] = r[key]["calls"][kind]
            assert got == want, key


# ---------------------------------------------------------------------------
# the kernel entries' shape-only path, the command line
# ---------------------------------------------------------------------------


def _entries():
    g = torch.Generator().manual_seed(0)
    table = torch.randn(40, 8, generator=g)
    ids = torch.randint(-1, 10, (5, 3, 4), generator=g, dtype=torch.int32)
    off = torch.tensor([0, 10, 20], dtype=torch.int64)
    grad = torch.randn(5, 3, 8, generator=g)
    q = torch.randn(2, 1, 4, 32, generator=g)
    k = torch.randn(2, 16, 2, 32, generator=g)
    kq = torch.randint(-127, 128, (2, 16, 2, 32), generator=g,
                       dtype=torch.int8)
    ks = torch.rand(2, 16, 2, 1, generator=g)
    return {
        "k1": (k1.hot_embedding_bag, (table, ids[:, 0]), {}),
        "k1 features": (k1.embedding_bag_features, (table, ids, off), {}),
        "k1 window": (k1.embedding_bag_features, (table[10:30], ids, off),
                      {"row_window": (10, 30), "out_dtype": torch.float32}),
        "k1_grad": (k1.hot_embedding_bag_grad, (grad[:, 0], ids[:, 0], 40),
                    {}),
        "k1_grad features": (k1.embedding_bag_features_grad,
                             (grad, ids, off, 20), {"row_window": (10, 30)}),
        "k3": (k3.flash_decode, (q, k, k), {"kv_len": 11}),
        "k3_partials": (k3.flash_decode_partials, (q, k, k),
                        {"kv_len": 11, "kv_offset": 4}),
        "k3_int8": (k3.flash_decode_int8, (q, kq, ks, kq, ks),
                    {"kv_len": 11}),
        "k3_int8_partials": (k3.flash_decode_int8_partials,
                             (q, kq, ks, kq, ks),
                             {"kv_len": 11, "kv_offset": 4}),
        "k2": (k3.flash_attention, (q.expand(2, 3, 4, 32).contiguous(),
                                    k, k), {}),
    }


@pytest.mark.parametrize("name", list(_entries()))
def test_kernel_entry_shape_only_path(name):
    """On meta tensors an entry gives its plain version's shapes and
    dtypes, reports one launch of work and moves no launch count; on the
    CPU tensors it is the plain version."""
    fn, args, kw = _entries()[name]
    before = (k1.launches, k1.window_launches, k1.grad_launches,
              dict(k3.launches))
    want = fn(*args, **kw)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    seen = []
    with fake.recording(lambda *r: seen.append(r)):
        got = fn(*meta, **kw)
    assert len(seen) == 1 and seen[0][1] > 0 and seen[0][2] > 0
    assert seen[0][0] == name.split()[0]
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    for g_, w_ in pairs:
        assert g_.device.type == "meta"
        assert (g_.shape, g_.dtype) == (w_.shape, w_.dtype)
    assert before == (k1.launches, k1.window_launches, k1.grad_launches,
                      dict(k3.launches))


def test_k1_grad_scratch_matches_layout():
    """The shape-only backward allocates ``GradLaunch``'s scratch: its
    size from the host copy of the kernel's plan (held to the C layout on
    the card, ``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        grad_scratch_bytes

    n, H, D = 65536 * 26 * 64, 130_000_384, 64
    b = grad_scratch_bytes(n, H, D, 2)
    assert b % 256 == 0 and b >= 2 * 8 * n + 4 * (H // 32)
    args = (torch.empty(4, 2, 64, dtype=torch.bfloat16, device="meta"),
            torch.empty(4, 2, 3, dtype=torch.int32, device="meta"),
            torch.empty(2, dtype=torch.int64, device="meta"), 100)
    tracer = dryrun._Tracer("meta")
    with tracer:
        k1.embedding_bag_features_grad(*args)
    assert tracer.peak == 100 * 64 * 2 + grad_scratch_bytes(24, 100, 64, 2)


def _allocator_peak(cell) -> int:
    """The CPU allocator's peak over one step of ``cell`` (its state and
    batch, which live through the step, and what the step allocates on top
    of them, from ``torch.profiler``'s memory events)."""
    from torch.profiler import ProfilerActivity, profile

    state = cell.init_state(torch.Generator().manual_seed(0))
    batch = dryrun._batch(cell)
    args, _ = dryrun._unique_bytes(dryrun._state_tensors(state)
                                   + list(batch.values()))
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = cell.run(state, batch)
        del out
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return args + peak


ALLOCATOR_TOL = 0.005
ALLOCATOR_CELLS = [  # naive attention; the first with its peak in the
    # softmax backward (scores of 8 heads at 512 tokens against d 256)
    ("deepseek-67b", "train_4k", 512, dict(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=1, head_dim=32,
        d_ff=512, vocab=1000)),
    ("olmoe-1b-7b", "train_4k", 256, dict(n_layers=2)),
    ("deepseek-67b", "prefill_32k", 256, dict(n_layers=2)),
]


@pytest.mark.parametrize("arch_id,shape,seq,over", ALLOCATOR_CELLS,
                         ids=[f"{a}-{s}" for a, s, _, _ in ALLOCATOR_CELLS])
def test_cpu_trace_peak_is_the_allocators(arch_id, shape, seq, over,
                                          monkeypatch):
    """The trace's peak on the CPU within ALLOCATOR_TOL of the CPU
    allocator's.  Where the peak lies in the softmax backward (whose CPU
    kernel copies its permuted gradient), the trace without that copy
    misses by more than a tenth."""
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "SMOKE_SEQ", seq)
    cfg = dataclasses.replace(get_arch(arch_id).SMOKE, **over)
    assert cfg.attn_impl == "naive"

    def cell():
        return build_cell(arch_id, shape, "cpu", batch=1, cfg_override=cfg)

    real = _allocator_peak(cell())
    traced = dryrun.trace_cell(cell())["memory"]["peak_memory_bytes"]
    assert abs(traced - real) <= ALLOCATOR_TOL * real, (traced, real)
    if (arch_id, shape) == ALLOCATOR_CELLS[0][:2]:
        monkeypatch.setattr(dryrun, "_SOFTMAX", set())
        blind = dryrun.trace_cell(cell())["memory"]["peak_memory_bytes"]
        assert real - blind > 0.1 * real, (blind, real)


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("permuted", [False, True])
def test_softmax_backward_scratch(device, permuted):
    """``_softmax_backward_data``'s inner tensors beside its output: on the
    card (``meta``) grad x output and, where that product is not
    contiguous, its contiguous copy; on the CPU a contiguous copy of a
    permuted gradient."""
    shape = (2, 3, 64, 64)
    n = 4 * math.prod(shape)
    out = torch.softmax(torch.zeros(shape, device=device), dim=-1)
    grad = torch.zeros(shape, device=device)
    if permuted:
        grad = torch.zeros((2, 64, 3, 64), device=device).transpose(1, 2)
    tracer = dryrun._Tracer(device)
    for t in (out, grad):
        tracer.track(t)
    with tracer:
        got = torch.ops.aten._softmax_backward_data(grad, out, -1,
                                                    torch.float32)
    assert got.shape == shape
    inner = {("meta", False): n, ("meta", True): 2 * n,
             ("cpu", False): 0, ("cpu", True): n}[device, permuted]
    assert tracer.peak == 3 * n + inner


def test_cli_writes_one_record(tmp_path):
    _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          "dlrm-rm2", "--shape", "serve_p99", "--mesh", "debug", "--out",
          str(tmp_path)])
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["dlrm-rm2__serve_p99__debug.json"]
    rec = json.loads(files[0].read_text())
    assert REF_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory"])
    assert rec["n_devices"] == 8 and rec["time_trace_s"] > 0
    assert rec["collectives"]["all-reduce_count"] == 1  # the pooled partial
    assert rec["kernels"]["k1"]["launches"] == 1
    assert np.isclose(rec["t_memory_s"], rec["bytes_per_device"] / 3.35e12)
