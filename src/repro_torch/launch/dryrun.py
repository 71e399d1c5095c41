"""Dry run: trace one step of every (architecture x shape) cell on the
production meshes without a card, and extract its roofline terms.

Counterpart of ``repro.launch.dryrun``, with its cells, record keys and
command line; run it as its own process (it starts a process group):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-rm2 \\
        --shape serve_p99 --mesh debug --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--out DIR`` elsewhere).  The reference fakes 512 host devices and
compiles each cell.  Here a fake world of ``torch.distributed`` (the
"fake" backend over a ``FakeStore``, which moves nothing) of the mesh's
size stands in for the ranks: 256 ranks for ``single``, 512 for
``multi``, 8 for ``debug``.  The real ``Mesh`` is built on it and rank 0
is traced, which holds the largest block wherever blocks differ.  The
trace runs the card's path on the ``meta`` device: the FULL config at the
shape's sizes, on tensors that hold no data and compute nothing, the
state made from shapes without a draw.  The kernel entries take their
shape-only path (``repro_torch.kernels.fake``), and the collectives run
on the fake group.  A train cell takes its gradient pass and its
optimizer update; any other cell its forward.

A record, per rank ("per_device" in the reference's keys):

- ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the step, plus each kernel entry's formula (K1: B·F·P·D adds;
  K1's backward: slots·D; K3: 4·B·H·kv_len·hd; a meta tensor holds no
  ids, so every slot counts as live);
- ``bytes_per_device``: eager PyTorch's traffic: every op's inputs read
  once and its outputs written once, a gather or scatter only the rows it
  touches, views free, each kernel entry its own count.  This is not
  XLA's fused "bytes accessed" of the reference's record, and not the
  same number;
- ``collective_bytes_per_device`` and ``collectives`` (bytes by kind,
  ``_count``s): a rank's bytes on the wire, counted by
  ``repro_torch.dist.collectives`` while the step runs (all-reduce twice
  and all-gather once its result's bytes), not read off a compiled graph;
- ``memory``: ``argument_size_bytes`` (the rank's state and batch),
  ``output_size_bytes`` (``alias_size_bytes`` of it the arguments the
  step updates in place), ``temp_size_bytes`` (the peak less the
  arguments) and ``peak_memory_bytes``: every storage on the device
  followed from its allocation to its release through the step;
- ``t_compute_s``, ``t_memory_s``, ``t_collective_s`` and ``bottleneck``
  at the data-sheet rates below.

A Python trace grows with an LM's depth, where the reference's scan does
not: an LM cell is traced at 1 and 2 layers and every count extrapolated
as c(1) + (L - 1)(c(2) - c(1)), the reference's own scan correction
(``benchmarks/roofline.py``); the record says so in ``depth``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ArchKind
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.dist import collectives
from repro_torch.kernels import fake
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, run_cell

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data-sheet rates, dense; not measured.
PEAK_FLOPS_16 = 989e12   # bf16 / f16 on the tensor cores
PEAK_FLOPS_32 = 67e12    # f32 outside them (the port runs with TF32 off)
HBM_BW = 3.35e12         # bytes/s
NODE_RANKS = 8           # ranks of one node: consecutive, NVLink-joined
NVLINK_BW = 450e9        # a collective within one node (NVLink 4, each way)
NET_BW = 50e9            # any other (one 400 Gb/s link a card)
WORLD = {"single": 256, "multi": 512, "debug": 8}

_FREE = {  # ops that move no data: allocation without a write, aliasing
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
    "resize_", "_local_scalar_dense"}
_WRITE_ONLY = {"copy_", "zero_", "fill_", "normal_", "uniform_"}
# gathers: the source's touched rows are the output's bytes
_GATHERS = {"embedding", "index_select", "gather", "index"}
# in-place scatters into self: only the rows they touch move
_SCATTERS = {"index_add_", "index_put_", "scatter_add_", "scatter_",
             "index_fill_", "index_copy_"}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tracer(TorchDispatchMode):
    """Counts each op's flops by dtype (FlopCounterMode's formulas), its
    bytes, and the live bytes of every storage on ``device_type``."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.flops: dict[str, int] = {}
        self.bytes = 0
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until it is released (once)."""
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def add_flops(self, dtype: torch.dtype, n: int) -> None:
        key = str(dtype).removeprefix("torch.")
        self.flops[key] = self.flops.get(key, 0) + int(n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry:
            # a composite op reaches here whole under inference_mode:
            # count its parts, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = {t.untyped_storage()._cdata for t in _tensors(args)
               + _tensors(kwargs) if t.device.type == self.device_type}
        for t in outs:  # a new storage, not a view or an in-place result
            if t.device.type == self.device_type and \
                    t.untyped_storage()._cdata not in ins:
                self.track(t)
        if packet in flop_registry:
            ins = _tensors(args)
            self.add_flops(ins[0].dtype,
                           flop_registry[packet](*args, **kwargs, out_val=out))
        self.bytes += self._bytes(func, args, kwargs, outs)
        return out

    def _bytes(self, func, args, kwargs, outs) -> int:
        name = func.overloadpacket.__name__
        if (func.namespace != "aten" or func.is_view or name in _FREE
                or name.endswith("_view")):
            return 0
        def mine(ts):
            return [t for t in ts if t.device.type == self.device_type]

        ins, outs = mine(_tensors(args) + _tensors(kwargs)), mine(outs)
        written = sum(_size(t) for t in outs)
        if name in _GATHERS:
            # the index (and, for embedding, nothing else) read whole; the
            # source only where the output reads it
            index = [t for t in ins[1:] if not t.is_floating_point()]
            return sum(_size(t) for t in index) + 2 * written
        if name in _SCATTERS:
            self_, rest = ins[0], ins[1:]
            src = [t for t in rest if t.is_floating_point()]
            touched = sum(_size(t) for t in src) or (
                max((t.numel() for t in rest), default=0)
                * self_.element_size())
            return sum(_size(t) for t in rest) + 2 * touched
        if name in _WRITE_ONLY:
            ins = ins[1:]
        return sum(_size(t) for t in ins) + written


def _node_local(group) -> bool:
    ranks = dist.get_process_group_ranks(group)
    return len({r // NODE_RANKS for r in ranks}) == 1


def _state_tensors(state) -> list[torch.Tensor]:
    if isinstance(state, dict):
        return [t for v in state.values() for t in _state_tensors(v)]
    if hasattr(state, "tree"):  # a recsys or GNN model
        return _state_tensors(state.tree())
    return _tensors(state)


def _batch(cell) -> dict:
    """The cell's batch on its device: data-free on ``meta``, zeros
    elsewhere (valid ids and tokens)."""
    make = torch.empty if cell.device.type == "meta" else torch.zeros
    return tree_map(lambda s: make(s.shape, dtype=s.dtype, device=cell.device),
                    cell.batch_specs)


def _unique_bytes(ts) -> tuple[int, set]:
    keys, total = set(), 0
    for t in ts:
        st = t.untyped_storage()
        if st._cdata not in keys:
            keys.add(st._cdata)
            total += st.nbytes()
    return total, keys


def trace_cell(cell) -> dict:
    """One step of ``cell`` (``launch.steps.build_cell``) traced on its
    device: the counts of a record (module docstring), without the
    roofline terms.  On ``meta`` nothing computes; on the CPU (a test's
    small cell) the step runs for real on zeros."""
    dev = cell.device
    gen = torch.Generator()
    if dev.type != "meta":
        gen = torch.Generator(dev).manual_seed(0)
    kernels: dict[str, dict] = {}
    coll = {"in_node": 0, "across": 0}
    colls: dict[str, float] = {}

    def on_kernel(name, flops, nbytes, dtype):
        k = kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0,
                                      "dtype": str(dtype).removeprefix(
                                          "torch.")})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def on_collective(kind, wire, group):
        key = kind.replace("_", "-")
        colls[key] = colls.get(key, 0) + wire
        colls[key + "_count"] = colls.get(key + "_count", 0) + 1
        coll["in_node" if _node_local(group) else "across"] += wire

    t0 = time.perf_counter()
    state = cell.init_state(gen)
    batch = _batch(cell)
    args = _state_tensors(state) + tree_leaves(batch)
    arg_bytes, arg_keys = _unique_bytes(args)
    tracer = _Tracer(dev.type)  # the arguments live at the step's start
    for t in args:
        tracer.track(t)
    counter = FlopCounterMode(display=False)
    with fake.recording(on_kernel), collectives.recording(on_collective), \
            counter, tracer:
        out = run_cell(cell, lambda: cell.run(state, batch))
    out_ts = [t for t in _tensors(out) + _state_tensors(out)
              if t.device.type == dev.type]
    out_bytes, _ = _unique_bytes(out_ts)
    alias_bytes, _ = _unique_bytes(
        [t for t in out_ts if t.untyped_storage()._cdata in arg_keys])
    del out, state, batch, args, out_ts
    counted = counter.get_total_flops()
    if counted != sum(tracer.flops.values()):
        raise AssertionError(f"FlopCounterMode counted {counted} flops, the "
                             f"tracer {sum(tracer.flops.values())}")
    flops = dict(tracer.flops)
    for k in kernels.values():
        flops[k["dtype"]] = flops.get(k["dtype"], 0) + k["flops"]
    return {
        "flops_per_device": sum(flops.values()),
        "flops_by_dtype": flops,
        "bytes_per_device": tracer.bytes + sum(k["bytes"]
                                               for k in kernels.values()),
        "collective_bytes_per_device": coll["in_node"] + coll["across"],
        "collective_bytes_in_node": coll["in_node"],
        "collectives": colls,
        "kernels": kernels,
        "memory": {"argument_size_bytes": arg_bytes,
                   "output_size_bytes": out_bytes,
                   "temp_size_bytes": tracer.peak - arg_bytes,
                   "alias_size_bytes": alias_bytes,
                   "peak_memory_bytes": tracer.peak,
                   "generated_code_size_bytes": None},
        "time_trace_s": time.perf_counter() - t0,
    }


def _extrapolate(one, two, L: int):
    """c(1) + (L - 1)(c(2) - c(1)) of every count of two traces."""
    if isinstance(one, dict) or isinstance(two, dict):
        one, two = one or {}, two or {}
        return {k: _extrapolate(one.get(k, 0), two.get(k, 0), L)
                for k in one.keys() | two.keys()}
    if isinstance(one, str) or one is None:
        return one
    return one + (L - 1) * (two - one)


def roofline(rec: dict) -> dict:
    """The three terms at the data-sheet rates, and the largest."""
    f = rec["flops_by_dtype"]
    fast = sum(v for k, v in f.items() if k in ("bfloat16", "float16"))
    rec["t_compute_s"] = fast / PEAK_FLOPS_16 + (
        rec["flops_per_device"] - fast) / PEAK_FLOPS_32
    rec["t_memory_s"] = rec["bytes_per_device"] / HBM_BW
    in_node = rec["collective_bytes_in_node"]
    rec["t_collective_s"] = in_node / NVLINK_BW + (
        rec["collective_bytes_per_device"] - in_node) / NET_BW
    terms = {"compute": rec["t_compute_s"], "memory": rec["t_memory_s"],
             "collective": rec["t_collective_s"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def fake_world(size: int) -> None:
    """A fake world of ``size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def make_mesh(mesh_kind: str):
    """The mesh of ``mesh_kind`` on a fake world of its size."""
    fake_world(WORLD[mesh_kind])
    if mesh_kind == "debug":
        return make_debug_mesh(device_type="cpu")
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type="cpu")


def run_cell_dryrun(arch_id: str, shape_name: str, mesh_kind: str,
                    save: bool = True, verbose: bool = True,
                    out_dir: str | pathlib.Path | None = None,
                    cfg_override=None, full_depth: bool = False) -> dict:
    """The record of one cell on the mesh ``mesh_kind`` ("single",
    "multi" or "debug"), written to ``out_dir`` (``ARTIFACTS``) with
    ``save``.  ``cfg_override`` replaces the arch's FULL config (an LM's
    depth is then extrapolated from it); ``full_depth`` traces an LM at
    its full depth instead of extrapolating."""
    arch = get_arch(arch_id)
    multi_pod = mesh_kind == "multi"
    mesh = make_mesh(mesh_kind)
    cfg = arch.FULL if cfg_override is None else cfg_override
    lm = arch.KIND in (ArchKind.LM_DENSE, ArchKind.LM_MOE)

    def trace(c):
        return trace_cell(build_cell(arch_id, shape_name, "meta", mesh=mesh,
                                     multi_pod=multi_pod, cfg_override=c))

    if lm and not full_depth and cfg.n_layers > 2:
        one, two = (trace(dataclasses.replace(cfg, n_layers=k))
                    for k in (1, 2))
        rec = _extrapolate(one, two, cfg.n_layers)
        rec["time_trace_s"] = one["time_trace_s"] + two["time_trace_s"]
        depth = "extrapolated from 1 and 2 layers"
    else:
        rec = trace(cfg_override)
        depth = "traced at full depth"
    rec = roofline({"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                    "n_devices": mesh.size, "rank": dist.get_rank(),
                    "depth": depth, **rec})
    if verbose:
        m = rec["memory"]
        print(f"[{arch_id} x {shape_name} x {mesh_kind}({mesh.size})] "
              f"trace {rec['time_trace_s']:.1f}s | flops/dev "
              f"{rec['flops_per_device']:.3e} bytes/dev "
              f"{rec['bytes_per_device']:.3e} coll/dev "
              f"{rec['collective_bytes_per_device']:.3e} | args "
              f"{m['argument_size_bytes'] / 1e9:.2f} GB peak "
              f"{m['peak_memory_bytes'] / 1e9:.2f} GB | bottleneck "
              f"{rec['bottleneck']}", flush=True)
    if save:
        out = pathlib.Path(out_dir or ARTIFACTS)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{arch_id}__{shape_name}__{mesh_kind}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


def all_cells():
    for arch_id in list_archs():
        for shape in get_arch(arch_id).SHAPES:
            yield arch_id, shape.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "debug"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", help=f"record directory (default {ARTIFACTS})")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    out_dir = pathlib.Path(args.out or ARTIFACTS)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    for mk in meshes:
        for arch_id, shape_name in cells:
            path = out_dir / f"{arch_id}__{shape_name}__{mk}.json"
            if args.skip_existing and path.exists():
                print(f"skip {path.name}")
                continue
            try:
                run_cell_dryrun(arch_id, shape_name, mk, out_dir=out_dir)
            except Exception as e:  # a failed cell is reported, the rest run
                failures.append((arch_id, shape_name, mk, repr(e)[:200]))
                print(f"FAIL [{arch_id} x {shape_name} x {mk}]: {e}",
                      flush=True)
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nAll dry-run cells passed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
