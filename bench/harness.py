"""One run of one cell: set-up, the measured window, the check, the line.

The cell's entry in ``BENCHMARK.json`` names a configuration and a
traffic.  The configuration file (``bench/configs/<name>.json``) holds the
model's sizes as they are run (any field of the port's ``RecsysConfig``
and ``EmbeddingConfig``), names the port's registered configuration they
must equal, the port's model class and the plain reference
(``bench/reference/<family>.py``), the control's precision and the limit
of the comparison.  The traffic file (``bench/traffic/<name>.json``) holds
the traffic's parameters, and its ``loop`` names the module
(``bench/loops/<loop>.py``) that draws the traffic's pool of batches and
offers them in the window.

Set-up draws the weights (``reference.draw_params``) and the loop's pool
on the device from the seed, builds the port's model on those weights,
and warms the step up on each batch size of the pool.  A step is the
loop's ``step(model, batch)`` (the port's ``model(batch)`` where the loop
has none) on a pool batch under ``torch.inference_mode``, with its scores
copied to the host; the loop decides which steps run when, until
``seconds`` have passed.  After the window the process's peak is read,
the model and its activations are freed, and every step's scores are
compared with the reference's scores of its batch (``bench.check``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import check, devtrace, gen, progtrace
from bench.reference import common

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    name: str
    sizes: dict
    traffic: dict
    e2e: list[dict]
    per_layer: list[dict]
    root: Path


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    latencies_s: list[float]
    which: list[int]                      # the pool batch of each step
    pool_items: list[int]                 # the items of each pool batch
    peaks: dict
    work: list[dict] | None = None        # a pool batch's needs (traced run)
    trace: devtrace.Summary | None = None
    program: progtrace.Summary | None = None  # the port's spans (traced run)

    @property
    def steps(self) -> int:
        return len(self.latencies_s)

    @property
    def items(self) -> int:
        return sum(self.pool_items[j] for j in self.which)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT, *, sizes: dict | None = None,
              traffic: dict | None = None) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json``; ``sizes`` / ``traffic``
    replace keys of its configuration / traffic file (tests run cells at
    small sizes on the CPU)."""
    manifest = read_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    cfg = read_json(root / "bench" / "configs" / f"{entry['config']}.json")
    tr = read_json(root / "bench" / "traffic" / f"{entry['traffic']}.json")
    cfg.update(sizes or {})
    tr.update(traffic or {})
    return Cell(name=name, sizes=cfg, traffic=tr,
                e2e=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _applies(m, name)],
                root=root)


def load_file(root: Path, kind: str, name: str):
    """``root/bench/<kind>/<name>.py`` as a module."""
    path = root / "bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cell: Cell):
    """The configuration's plain reference, ``bench/reference/<family>.py``:
    ``draw_params(sizes, generator, device)``, ``scores(params, batch,
    sizes, precision)`` and ``work(sizes, stats)``; optionally
    ``stats(sizes, batch)`` (what ``work`` reads of a pool batch; else
    ``batch_stats``) and ``item_bytes(sizes)`` (the largest temporary of
    one item in ``scores``, which sizes the check's blocks of rows; else
    ``common.gather_bytes``)."""
    return load_file(cell.root, "reference", cell.sizes["family"])


def metric_reader(root: Path, name: str):
    """``bench/metrics/<name>.py``, else the file of the name's part
    before its first dot; its ``read(run)`` gives the value or None."""
    if not (root / "bench" / "metrics" / f"{name}.py").is_file():
        name = name.split(".")[0]
    return load_file(root, "metrics", name).read


def loop(cell: Cell):
    """The traffic's loop, ``bench/loops/<loop>.py``: ``draw_pool(sizes,
    traffic, seed, device)`` gives the pool of batches, and
    ``window(launch, finish, pool, traffic, seconds)`` offers them and
    gives (window s, each step's latency s).  Optionally ``step(model,
    batch)``, the scores of a batch's items (else ``model(batch)``);
    ``items(batch)``, how many items a batch scores (else the rows of its
    ``sparse_ids``); ``take(batch, idx)``, the batch of those items alone,
    for the reference (else every tensor of the batch indexed by them)."""
    return load_file(cell.root, "loops", cell.traffic["loop"])


def _model_step(model, batch: dict) -> torch.Tensor:
    return model(batch)


def _sparse_items(batch: dict) -> int:
    return batch["sparse_ids"].shape[0]


def items_of(lp, pool: list[dict]) -> list[int]:
    items = getattr(lp, "items", _sparse_items)
    return [items(b) for b in pool]


# --- the port ---------------------------------------------------------------


# configuration-file keys that differ from the EmbeddingConfig field's name
EMBEDDING_KEYS = {"dim": "embed_dim", "dtype": "table_dtype"}


def _fields(cls, sizes: dict, keys: dict) -> dict:
    """The fields of dataclass ``cls`` that the configuration file gives
    (under ``keys.get(field, field)``): a dtype by its name, a list as a
    tuple, anything else as it is."""
    out = {}
    for f in dataclasses.fields(cls):
        key = keys.get(f.name, f.name)
        if key not in sizes:
            continue
        v = sizes[key]
        if f.name == "dtype":
            v = common.DTYPES[v]
        elif isinstance(v, list):
            v = tuple(v)
        out[f.name] = v
    return out


def port_config(sizes: dict):
    """The port's RecsysConfig of these sizes: every field of it and of its
    EmbeddingConfig that the file gives, the dataclass default where it
    gives none.  Held equal to the port's registered configuration that
    the file names, so that the benchmark never measures another model
    under the configuration's name."""
    from repro_torch.models.embedding import EmbeddingConfig
    from repro_torch.models.recsys_base import RecsysConfig

    return RecsysConfig(
        **_fields(RecsysConfig, sizes, {}),
        embedding=EmbeddingConfig(**_fields(EmbeddingConfig, sizes,
                                            EMBEDDING_KEYS)))


def registered_config(sizes: dict):
    reg = sizes["port_config"]
    obj = getattr(importlib.import_module(reg["module"]), reg["attr"])
    return obj(*reg.get("args", ())) if callable(obj) else obj


def check_registered(sizes: dict) -> None:
    want = registered_config(sizes)
    got = port_config(sizes)
    if got != want:
        raise SystemExit(f"bench: the configuration {sizes['name']!r} is not "
                         f"the port's {sizes['port_config']}:\n  file: {got}"
                         f"\n  port: {want}")


def port_model(sizes: dict, cfg, params):
    from repro_torch.models import RECSYS_MODELS

    cls = getattr(RECSYS_MODELS[cfg.interaction], sizes["port_model"])
    return cls(cfg, params)


def traced_methods(model) -> None:
    """The model's SparseNet and DenseNet, each inside a host span, where
    the model has them (DLRM's and Wide & Deep's two halves)."""
    for attr, span in (("apply_sparse", "sparse"),
                       ("apply_dense_given_pooled", "dense")):
        fn = getattr(model, attr, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _span=devtrace.SPAN_PREFIX + span):
            with torch.profiler.record_function(_span):
                return _fn(*args)

        setattr(model, attr, wrapped)


# --- the run ----------------------------------------------------------------


# rows of each pool batch whose answers every step keeps for the check
SAMPLE_ROWS = 4096
# steps run on each batch size of the pool before the window
WARMUP_STEPS = 2


def sample_rows(pool_items: list[int], seed: int) -> list[torch.Tensor]:
    """For each pool batch, the rows whose answers are kept and checked:
    ``SAMPLE_ROWS`` of its items (all where it has fewer), drawn from the
    seed, in order."""
    out = []
    for j, n in enumerate(pool_items):
        g = gen.generator(gen.subseed(seed, 3, j), torch.device("cpu"))
        idx = torch.randperm(n, generator=g)[:SAMPLE_ROWS]
        out.append(idx.sort().values)
    return out


class Answers:
    """Each step's scores on the host, and the answers kept for the check.

    A step's scores are copied whole into a pinned host buffer (one DMA,
    one buffer for each step that may be in flight), and the step ends
    when that copy has finished: its scores are on the host.  The answers
    of its pool batch's sampled rows then go into an arena allocated and
    touched at set-up, so that the window allocates no host memory (a
    first touch of fresh host pages costs the host milliseconds a step).
    On a CPU device the scores are already on the host."""

    def __init__(self, rows: list[torch.Tensor], depth: int):
        self.rows = rows
        self.pinned: list[torch.Tensor | None] = [None] * depth
        self.done: list = [None] * depth
        self.chunks: list[torch.Tensor] = []
        self.cap = 0
        self.which: list[int] = []

    def reserve(self, like: torch.Tensor, steps: int) -> None:
        """Room for ``steps`` more steps' answers, shaped as ``like``'s
        but for its rows."""
        shape = (steps, max(map(len, self.rows)), *like.shape[1:])
        self.chunks.append(torch.zeros(shape, dtype=like.dtype))
        self.cap += steps

    def start(self, i: int, scores: torch.Tensor):
        """Step i's copy to the host, queued behind its scores."""
        if scores.device.type != "cuda":
            return scores
        b = i % len(self.pinned)
        if self.pinned[b] is None or self.pinned[b].shape != scores.shape:
            self.pinned[b] = torch.empty(scores.shape, dtype=scores.dtype,
                                         pin_memory=True)
            self.done[b] = torch.cuda.Event()
        self.pinned[b].copy_(scores, non_blocking=True)
        self.done[b].record()
        return b

    def finish(self, j: int, started) -> None:
        """Wait for a step's scores on the host; keep pool batch j's
        sampled answers."""
        if isinstance(started, int):
            self.done[started].synchronize()
            started = self.pinned[started]
        k = len(self.which)
        if k == self.cap:
            self.reserve(started, max(16, self.cap))
        c, i = self._slot(k)
        torch.index_select(started, 0, self.rows[j],
                           out=c[i, :len(self.rows[j])])
        self.which.append(j)

    def _slot(self, k: int):
        for c in self.chunks:
            if k < c.shape[0]:
                return c, k
            k -= c.shape[0]
        raise IndexError(k)

    def answer(self, k: int) -> torch.Tensor:
        c, i = self._slot(k)
        return c[i, :len(self.rows[self.which[k]])]

    def clear(self) -> None:
        """Drop the kept answers (the warm-up's)."""
        self.which = []


def make_step(step, model, pool: list[dict], answers: Answers,
              traced: bool):
    """(launch, finish): ``launch(i, j)`` queues step i, ``step(model,
    batch)`` on pool batch j, and its scores' copy to the host;
    ``finish(j, started)`` waits for them and keeps the answers."""
    def launch(i: int, j: int):
        with torch.inference_mode():
            return answers.start(i, step(model, pool[j]))

    if not traced:
        return launch, answers.finish
    traced_methods(model)
    rf = torch.profiler.record_function

    def traced_launch(i: int, j: int):
        with rf(devtrace.SPAN_PREFIX + "step"):
            return launch(i, j)

    def traced_finish(j: int, started) -> None:
        with rf(devtrace.SPAN_PREFIX + "d2h"):
            answers.finish(j, started)

    return traced_launch, traced_finish


def batch_stats(sizes: dict, batch: dict) -> dict:
    """Items, live ids and distinct table rows of a pool batch (a row
    counted once however many ids read it)."""
    ids = batch["sparse_ids"]
    off = torch.tensor(common.row_offsets(sizes), dtype=torch.int64,
                       device=ids.device)[None, :, None]
    seen = torch.zeros(common.total_rows(sizes), dtype=torch.bool,
                       device=ids.device)
    live = 0
    block = max(1, (1 << 26) // (ids.shape[1] * ids.shape[2]))
    for r0 in range(0, ids.shape[0], block):
        b = ids[r0:r0 + block]
        m = b >= 0
        live += int(m.sum())
        seen[(b.long() + off)[m]] = True
    return {"items": ids.shape[0], "live": live, "distinct": int(seen.sum())}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``bench/run.py`` prints no result while one is loaded)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def draw_inputs(cell: Cell, ref, lp, seed: int, device: torch.device):
    """The weights and the traffic's pool, drawn on ``device`` from the
    seed: what the program and the reference are both given."""
    with torch.no_grad():
        params = ref.draw_params(
            cell.sizes, gen.generator(gen.subseed(seed, 1), device), device)
        pool = lp.draw_pool(cell.sizes, cell.traffic, seed, device)
    return params, pool


def control_reading(cell: Cell, seed: int, device: torch.device
                    ) -> check.Verdict:
    """The control on the cell's inputs of ``seed``: the reference in the
    configuration's lower precision, in the program's place."""
    ref, lp = reference(cell), loop(cell)
    params, pool = draw_inputs(cell, ref, lp, seed, device)
    rows = sample_rows(items_of(lp, pool), seed)
    return check.control_gap(ref, params, pool, cell.sizes, rows,
                             take=getattr(lp, "take", None))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_process: float | None = None) -> dict:
    """One run: the result line's content (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``)."""
    t_process = time.perf_counter() if t_process is None else t_process
    sizes, tr = cell.sizes, cell.traffic
    ref, lp = reference(cell), loop(cell)
    cfg = port_config(sizes)
    peaks = read_json(cell.root / "bench" / "peaks.json")
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    params, pool = draw_inputs(cell, ref, lp, seed, device)
    model = port_model(sizes, cfg, params)
    pool_items = items_of(lp, pool)
    answers = Answers(sample_rows(pool_items, seed), tr["in_flight"])
    launch, finish = make_step(getattr(lp, "step", _model_step), model,
                               pool, answers, traced)
    first = {}
    for j, n in enumerate(pool_items):
        first.setdefault(n, j)
    i = 0
    for j in first.values():
        for _ in range(WARMUP_STEPS):
            t0 = time.perf_counter()
            finish(j, launch(i, j))
            t_step = time.perf_counter() - t0
            i += 1
    # room for twice the steps the last warm-up step's pace gives the window
    answers.reserve(answers.answer(0), int(2 * seconds / t_step) + 16)
    answers.clear()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process

    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    # no cyclic collection in the window: it would scan every object the
    # imports made, for milliseconds, in a step chosen by chance
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.record_function(devtrace.SPAN_PREFIX + "window"):
            window_s, lat = lp.window(launch, finish, pool, tr, seconds)
    finally:
        gc.enable()
        if prof is not None:
            prof.__exit__(None, None, None)
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    del model, launch, finish
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell=cell, setup_s=setup_s,
              window_s=window_s, latencies_s=lat, which=answers.which,
              pool_items=pool_items, peaks=peaks)
    if traced:
        events = devtrace.events_from_profiler(prof)
        prof = None
        run.trace = devtrace.summarize(events)
        run.program = progtrace.summarize(events)
        del events
        stats = getattr(ref, "stats", batch_stats)
        with torch.inference_mode():
            run.work = [ref.work(sizes, stats(sizes, b)) for b in pool]
    verdict = check.compare(ref, params, pool, sizes, answers,
                            take=getattr(lp, "take", None))
    del answers

    metrics = {}
    for m in (cell.per_layer if traced else cell.e2e):
        value = metric_reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card_info(device)
    dev["memory_peak_bytes"] = mem_peak
    out = {"correct": verdict.correct, "attempted": run.steps,
           "failed": verdict.failed, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": [list(x) for x in run.trace.device_ops],
            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    out["checks"] = verdict.checks
    out["_notes"] = _notes(run)
    if traced:
        out["_notes"].append(progtrace.idle_note(run.program))
    return out


def _notes(run: Run) -> list[str]:
    """Lines for standard error: the latency's median beside its tail, the
    sample count and what was attempted."""
    lat = sorted(x * 1e3 for x in run.latencies_s)
    if not lat:
        return ["no step finished in the window"]
    med = lat[len(lat) // 2]
    p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))]
    return [f"steps {run.steps} items {run.items} window_s {run.window_s:.6f}",
            f"step_ms median {med:.6f} p95 {p95:.6f} max {lat[-1]:.6f} "
            f"samples {len(lat)}",
            f"setup_s {run.setup_s:.6f}"]
