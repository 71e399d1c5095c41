"""A configuration of another family than DLRM's and Wide & Deep's is
added by files alone (``bench/README.md``): in a copy of the benchmark, a
configuration file equal to the port's ``din_arch.FULL`` (DIN, arXiv:
1706.06978: a quotient-remainder item table of 600 M ids in 74,692 rows,
a 100-item history, attention unit 80-40, top MLP 200-80, float32), a
throwaway plain reference of DIN, a loop that scores one user's history
against candidates through ``DIN.retrieval_scores``, a traffic and a
cell.  The cell runs on the CPU at the configuration's full size with a
few hundred candidates, and no file of the copy is edited."""
import json
import shutil

import pytest

from bench import devtrace, harness, progtrace

ROOT = harness.ROOT

# din_arch.FULL, every field given
DIN = {
    "name": "din",
    "source": "https://arxiv.org/abs/1706.06978",
    "family": "din_test",
    "port_config": {"module": "repro_torch.configs.din_arch",
                    "attr": "FULL"},
    "port_model": "DIN",
    "interaction": "target-attn",
    "vocab_sizes": [600000000, 1000000, 100000],
    "pooling": [1, 1, 1],
    "embed_dim": 18,
    "combine": "sum",
    "qr_features": [0],
    "qr_buckets": 65536,
    "table_dtype": "float32",
    "row_pad": 512,
    "n_dense": 0,
    "bottom_mlp": [],
    "top_mlp": [200, 80],
    "seq_len": 100,
    "attn_mlp": [80, 40],
    "use_gru": False,
    "n_interests": 0,
    "capsule_iters": 3,
    "n_tasks": 1,
    "dtype": "float32",
    "control": "tf32",
    # between the program's gaps (float32 against float32) and the TF32
    # control's on the CPU; a test's limit, not a calibrated one
    "score_gap_limit": 3e-4,
    "reduced": [],
}

REFERENCE = '''"""Plain DIN (arXiv:1706.06978), one user's history against candidates,
for a test.  Feature 0 is the item table (quotient-remainder rows where
the configuration says so), features 1.. are one-hot profile tables.  A
candidate's score: the attention unit (an MLP over [h, t, h - t, h * t],
ReLU between layers) weighs each live history item, the weighted sum and
the candidate's and profile rows go through the top MLP."""
import torch

from bench.reference import common


def _offsets(sizes):
    out, acc = [], 0
    for f, v in enumerate(sizes["vocab_sizes"]):
        out.append(acc)
        if f in sizes["qr_features"]:
            v = -(-v // sizes["qr_buckets"]) + sizes["qr_buckets"]
        acc += v
    return out, acc


def draw_params(sizes, gen, device):
    d = sizes["embed_dim"]
    _, raw = _offsets(sizes)
    rows = -(-raw // sizes["row_pad"]) * sizes["row_pad"]
    n_prof = len(sizes["vocab_sizes"]) - 1
    return {
        "embedding": {"table": torch.empty((rows, d), device=device)
                      .uniform_(-0.5, 0.5, generator=gen)},
        "attn_mlp": common.draw_mlp([4 * d, *sizes["attn_mlp"], 1],
                                    torch.float32, gen, device),
        "top_mlp": common.draw_mlp([(2 + n_prof) * d, *sizes["top_mlp"], 1],
                                   torch.float32, gen, device),
    }


def _items(table, ids, sizes):
    base = _offsets(sizes)[0][0]
    ids = ids.clamp_min(0).long()
    if 0 not in sizes["qr_features"]:
        return table[base + ids]
    qb = sizes["qr_buckets"]
    q_rows = -(-sizes["vocab_sizes"][0] // qb)
    return table[base + ids // qb] * table[base + q_rows + ids % qb]


def scores(params, batch, sizes, precision):
    table = params["embedding"]["table"]
    hist = batch["history_ids"][0]
    live = hist >= 0
    h = common.rounded(_items(table, hist, sizes) * live[:, None], precision)
    t = common.rounded(_items(table, batch["candidate_ids"], sizes),
                       precision)
    n, T = t.shape[0], h.shape[0]
    hh, tt = h[None].expand(n, T, -1), t[:, None].expand(n, T, -1)
    w = common.mlp(torch.cat([hh, tt, hh - tt, hh * tt], dim=-1),
                   params["attn_mlp"], precision, final_relu=False)[..., 0]
    w = torch.where(live[None], w, 0.0)
    interest = common.matmul(w[:, None, :], hh, precision)[:, 0]
    off = _offsets(sizes)[0]
    prof = [table[off[f] + batch["profile_ids"][0, f - 1].long()]
            for f in range(1, len(off))]
    x = torch.cat([interest, t, *(common.rounded(p, precision).expand(n, -1)
                                  for p in prof)], dim=-1)
    return common.mlp(x, params["top_mlp"], precision,
                      final_relu=False)[:, 0]


def item_bytes(sizes):
    return sizes["seq_len"] * (4 * sizes["embed_dim"]
                               + max(sizes["attn_mlp"])) * 4


def stats(sizes, batch):
    return {"items": batch["candidate_ids"].shape[0],
            "history": int((batch["history_ids"] >= 0).sum())}


def work(sizes, stats):
    d, n, T = sizes["embed_dim"], stats["items"], stats["history"]
    attn = [4 * d, *sizes["attn_mlp"], 1]
    top = [(1 + len(sizes["vocab_sizes"])) * d, *sizes["top_mlp"], 1]
    flops = n * T * sum(2 * a * b for a, b in zip(attn[:-1], attn[1:]))
    flops += n * sum(2 * a * b for a, b in zip(top[:-1], top[1:]))
    return {"k1": [], "step": {"bytes": n * (2 * d * 4 + 4 + 4),
                               "flops": {"float32": flops}}}
'''

LOOP = '''"""One user's history against candidates, calls back to back: pool
batch j holds one history of ``seq_len`` items (its last ones -1 past a
length drawn from half to all of it), one id of each profile table and
``traffic["candidates"]`` candidate ids, all uniform over their tables."""
import torch

from bench import gen
from bench.loops.closed import window  # noqa: F401


def draw_pool(sizes, traffic, seed, device):
    vocab, T = sizes["vocab_sizes"], sizes["seq_len"]
    pool = []
    for j in range(traffic["pool"]):
        g = gen.generator(gen.subseed(seed, 2, j), device)

        def ids(v, shape):
            return torch.randint(0, v, shape, generator=g, device=device,
                                 dtype=torch.int32)

        hist = ids(vocab[0], (1, T))
        hist[:, int(torch.randint(T // 2, T + 1, (1,), generator=g,
                                  device=device)):] = -1
        pool.append({
            "history_ids": hist,
            "profile_ids": torch.cat([ids(v, (1, 1)) for v in vocab[1:]],
                                     dim=1),
            "candidate_ids": ids(vocab[0], (traffic["candidates"],))})
    return pool


def step(model, batch):
    return model.retrieval_scores(batch, batch["candidate_ids"])


def items(batch):
    return batch["candidate_ids"].shape[0]


def take(batch, idx):
    return dict(batch, candidate_ids=batch["candidate_ids"][idx])
'''

TRAFFIC = {"name": "din_test", "loop": "one_history", "candidates": 300,
           "pool": 2, "in_flight": 1,
           "why": "one caller, one history against 300 candidates a call"}
CELL = "din-test.retrieval"
SEEDS = [11, 2**31 + 7, 912345678901]


@pytest.fixture(scope="module")
def din_copy(tmp_path_factory):
    """A copy of the benchmark with the DIN cell's files added."""
    root = tmp_path_factory.mktemp("din_bench")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "bench/configs/din-test.json").write_text(json.dumps(DIN))
    (root / "bench/reference/din_test.py").write_text(REFERENCE)
    (root / "bench/loops/one_history.py").write_text(LOOP)
    (root / "bench/traffic/din_test.json").write_text(json.dumps(TRAFFIC))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "din-test", "source": DIN["source"],
         "file": "bench/configs/din-test.json", "reduced": [],
         "why": "a test's configuration"})
    manifest["workloads"].append(
        {"name": CELL, "config": "din-test", "traffic": "din_test",
         "chips": 1, "why": "a test's cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("p95_ms", "mlp_ms.tail", "program_idle_ms.tail"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_din_cell_runs_from_files_alone(din_copy, cpu):
    before = _files(din_copy)
    cell = harness.load_cell(CELL, din_copy)
    harness.check_registered(cell.sizes)
    out = harness.run_cell(cell, 77, 0.2, False, cpu)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    # the p95 reader needs two calls; a loaded CPU may finish one
    assert set(out["metrics"]) == {"setup_s"} | (
        {"p95_ms"} if out["attempted"] > 1 else set())
    assert f"items {300 * out['attempted']} " in out["_notes"][0]
    traced = harness.run_cell(cell, 78, 0.2, True, cpu)
    assert traced["correct"], traced["checks"]
    assert traced["_notes"][-1].startswith("program idle")
    assert _files(din_copy) == before


@pytest.mark.parametrize("seed", SEEDS)
def test_din_control_fails_and_program_passes(din_copy, cpu, seed):
    cell = harness.load_cell(CELL, din_copy)
    control = harness.control_reading(cell, seed, cpu)
    gap = control.checks["score_gap"]
    assert not control.correct and gap["value"] > gap["limit"]
    program = harness.run_cell(cell, seed, 0.1, False, cpu)
    assert program["correct"]
    assert program["checks"]["score_gap"]["value"] < gap["limit"]


def test_din_file_is_the_ports_config():
    from repro_torch.configs import din_arch

    assert harness.port_config(DIN) == din_arch.FULL
    harness.check_registered(DIN)


@pytest.mark.parametrize("key,value", [("embed_dim", 16),
                                       ("attn_mlp", [80, 48]),
                                       ("top_mlp", [200, 64]),
                                       ("seq_len", 50)])
def test_din_file_with_a_change_is_refused(key, value):
    with pytest.raises(SystemExit):
        harness.check_registered(dict(DIN, **{key: value}))


def test_traced_run_hands_the_port_spans_to_their_readers(din_copy, cpu,
                                                          monkeypatch):
    """A traced run reduces the profiler's events, the same list the
    device trace's reduction reads, with ``progtrace.summarize`` into
    ``Run.program``, where the span readers find it.  On the CPU no device
    operation is recorded, so a stand-in reduction gives the readers
    something to read."""
    seen = {}
    real = devtrace.summarize

    def dev(events):
        seen["dev"] = events
        return real(events)

    def prog(events):
        seen["prog"] = events
        return progtrace.Summary(device_s={"mlp": 0.03, "outside": 0.01},
                                 idle_by_span_s={"mlp": 0.002,
                                                 "outside": 0.5},
                                 steps=3)

    monkeypatch.setattr(devtrace, "summarize", dev)
    monkeypatch.setattr(progtrace, "summarize", prog)
    out = harness.run_cell(harness.load_cell(CELL, din_copy), 79, 0.1, True,
                           cpu)
    assert seen["prog"] is seen["dev"] and seen["prog"]
    assert out["correct"]
    assert out["metrics"]["mlp_ms.tail"]["value"] == pytest.approx(10.0)
    assert out["metrics"]["program_idle_ms.tail"]["value"] == pytest.approx(
        2 / 3)
    assert out["_notes"][-1].startswith("program idle_ms a step ")
